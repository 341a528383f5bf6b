"""The port's data layer == the JAX package's, on the CPU.

The LIBSVM parsers (the port's native copy of the C++ parser, its Python
parser, and the JAX package's ``load_libsvm_lists``) are held bitwise equal
on features, labels and qids, and all of them raise on malformed rows. The
in-memory feed, its device prefetch and the K-step stacking give the JAX
package's batches in its order. The TFRecord writer and the TensorBoard
event writer write the JAX package's bytes. Files are written from numpy
seeds under ``tmp_path``.
"""

import glob
import os
import time

import numpy as np
import pytest
import torch

from ranking_tpu.data import batch as jax_batch
from ranking_tpu.data import dataset as jax_dataset
from ranking_tpu.data import libsvm as jax_libsvm
from ranking_tpu.data import tfrecord as jax_tfrecord
from ranking_tpu.utils import tensorboard as jax_tensorboard
from ranking_tpu_torch.data import batch as batch_lib
from ranking_tpu_torch.data import dataset
from ranking_tpu_torch.data import libsvm
from ranking_tpu_torch.data import native
from ranking_tpu_torch.data import tfrecord
from ranking_tpu_torch.utils import tensorboard

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

# Rows the generator does not write: a comment line, a blank line, a
# trailing comment, tabs and CR, a feature index past num_features, index
# 0, a non-numeric qid, exponent notation, a list longer than list_size,
# a row with no features.
_EDGE_ROWS = (
    '# a comment line\n'
    '\n'
    '2 qid:q-7 1:0.5 3:-1.25e-3 # trailing comment\n'
    '0\tqid:q-7\t2:3\t9:4.0\r\n'
    '1 qid:q-7 0:7 6:1e2\n'
    '4 qid:900 \n'
) + ''.join(f'{i % 5} qid:long 1:{i} 2:{-i}.5\n' for i in range(11))


def _write(tmp_path, name='train.txt', seed=0):
  path = str(tmp_path / name)
  libsvm.write_random_lists(path, 7, 6, 1, 9, seed=seed)
  with open(path, 'a') as f:
    f.write(_EDGE_ROWS)
  return path


@pytest.mark.parametrize('list_size', [4, 9])
def test_native_and_python_parsers_equal_the_jax_package(tmp_path,
                                                         list_size):
  path = _write(tmp_path)
  want = jax_libsvm.load_libsvm_lists(path, list_size, 6, use_native=False)
  parses = native.parses
  got_native = libsvm.load_libsvm_lists(path, list_size, 6)
  assert native.parses == parses + 1  # the native parser ran
  got_python = libsvm.load_libsvm_lists(path, list_size, 6,
                                        use_native=False)
  assert native.parses == parses + 1
  for got in (got_native, got_python):
    for a, b in zip(got, want):
      assert a.dtype == b.dtype and a.shape == b.shape
      np.testing.assert_array_equal(a, b)
  assert list(want[2][-3:]) == ['q-7', '900', 'long']
  assert libsvm.infer_num_features(path) == jax_libsvm.infer_num_features(
      path) == 9


@pytest.mark.parametrize('row', ['2 1:0.1 2:0.2\n', '1 qid:3 x:0.5\n'],
                         ids=['missing_qid', 'bad_feature_token'])
def test_malformed_rows_raise(tmp_path, row):
  path = str(tmp_path / 'bad.txt')
  with open(path, 'w') as f:
    f.write('1 qid:1 1:0.5 2:0.3\n' + row)
  with pytest.raises(ValueError, match='malformed LIBSVM'):
    libsvm.load_libsvm_lists(path, 4, 2)
  with pytest.raises(ValueError):
    libsvm.load_libsvm_lists(path, 4, 2, use_native=False)
  with pytest.raises(ValueError):
    jax_libsvm.load_libsvm_lists(path, 4, 2, use_native=False)


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
  """No quiet fall back to the Python parser: without a compiler the
  native path raises."""
  path = _write(tmp_path)
  monkeypatch.setattr(native, '_lib', None)
  monkeypatch.setattr(native, 'library_path',
                      lambda: str(tmp_path / 'build' / 'lib.so'))
  monkeypatch.setattr(native.shutil, 'which', lambda name: None)
  with pytest.raises(native.NativeBuildError, match='no C\\+\\+ compiler'):
    libsvm.load_libsvm_lists(path, 4, 6)
  assert not os.path.exists(tmp_path / 'build' / 'lib.so')


def _assert_batches_equal(got, want):
  assert set(got.examples) == set(want.examples) and not got.context
  for k in want.examples:
    np.testing.assert_array_equal(got.examples[k].numpy(),
                                  np.asarray(want.examples[k]))
  np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
  np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


@pytest.mark.parametrize('shuffle', [True, False])
def test_feed_gives_the_jax_batch_sequence(tmp_path, shuffle):
  features, labels, _ = libsvm.load_libsvm_lists(_write(tmp_path), 9, 6)
  kw = dict(batch_size=3, epochs=2, shuffle=shuffle, seed=5,
            drop_remainder=not shuffle)
  want = list(jax_dataset.prefetch_to_device(
      jax_dataset.in_memory_batches(features, labels, **kw),
      flat_examples=True))
  got = list(dataset.prefetch_to_device(
      dataset.in_memory_batches(features, labels, **kw), device='cpu',
      flat_examples=True))
  assert len(got) == len(want) == (8 if shuffle else 6)
  for g, w in zip(got, want):
    _assert_batches_equal(g, w)
  # K batches stacked for one dispatch, as the JAX pipeline stacks them.
  host = list(dataset.in_memory_batches(features, labels, **kw))[:3]
  stacked = batch_lib.stack_numpy_batches(
      [dataset.flatten_examples(b) for b in host])
  want = jax_batch.stack_numpy_batches(
      [jax_dataset.flatten_examples(b) for b in
       jax_dataset.in_memory_batches(features, labels, **kw)][:3])
  _assert_batches_equal(stacked, want)
  with pytest.raises(ValueError, match='no batches'):
    batch_lib.stack_numpy_batches([])


@pytest.mark.parametrize('lists', [0, 3])
def test_a_repeated_feed_that_makes_no_batch_raises(lists):
  """0 lists, or 3 lists under batches of 4 dropping the remainder, make
  no batch: one epoch is an empty stream, and more raise at once instead
  of looking for a batch forever."""
  features = np.zeros((lists, 5, 2), np.float32)
  labels = np.zeros((lists, 5), np.float32)
  assert list(dataset.in_memory_batches(features, labels, 4)) == []
  for epochs in (None, 2):
    batches = dataset.in_memory_batches(features, labels, 4, epochs=epochs)
    start = time.monotonic()
    with pytest.raises(ValueError, match=f'{lists} lists'):
      next(batches)
    assert time.monotonic() - start < 1
  if lists:  # the remainder kept is a batch: the stream repeats it
    kept = dataset.in_memory_batches(features, labels, 4, epochs=None,
                                     drop_remainder=False)
    assert [next(kept).labels.shape[0] for _ in range(3)] == [lists] * 3


def test_tfrecord_writer_writes_the_jax_bytes(tmp_path):
  rng = np.random.RandomState(3)
  records = [rng.bytes(n) for n in (0, 1, 7, 300, 5000)]
  assert tfrecord.write_records(str(tmp_path / 'a.tfrecord'), records) == 5
  jax_tfrecord.write_records(str(tmp_path / 'b.tfrecord'), records)
  assert ((tmp_path / 'a.tfrecord').read_bytes()
          == (tmp_path / 'b.tfrecord').read_bytes())
  assert list(jax_tfrecord.read_records(str(tmp_path / 'a.tfrecord'),
                                        verify=True)) == records
  for data in records:
    assert tfrecord.crc32c(data) == jax_tfrecord.crc32c(data)


def test_tensorboard_writer_writes_the_jax_bytes(tmp_path, monkeypatch):
  """At a fixed wall time the two writers' files are equal byte for byte:
  a scalar of exactly 0.0 survives, an empty summary is left out, and
  negative and large steps, an empty tag and a value beyond float32
  encode as protobuf encodes them."""
  monkeypatch.setattr(time, 'time', lambda: 1760000000.25)
  for name, module in (('jax', jax_tensorboard), ('port', tensorboard)):
    w = module.SummaryWriter(str(tmp_path / name))
    w.scalars(3, {'loss': 0.0, 'ndcg@5': 0.5, 'tiny': -1e-30, 'big': 1e40})
    w.scalars(0, {})
    w.scalars(-5, {'': 2.0})
    w.scalars(2 ** 40, {'val_loss': 1.5}, wall_time=0.0)
    w.close()
  (port,) = glob.glob(str(tmp_path / 'port' / 'events.out.tfevents.*'))
  (ref,) = glob.glob(str(tmp_path / 'jax' / 'events.out.tfevents.*'))
  assert os.path.basename(port) == os.path.basename(ref)
  with open(port, 'rb') as a, open(ref, 'rb') as b:
    assert a.read() == b.read()
  assert len(list(jax_tfrecord.read_records(port, verify=True))) == 5
