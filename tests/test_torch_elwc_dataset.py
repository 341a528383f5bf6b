"""The port's TFRecord streams == the JAX package's, batch for batch.

Three small ELWC files (written with the port's encoder) are read by
``build_ranking_dataset`` (the Python stream) and by
``native_ranking_dataset`` (the C++ loader) of both packages, over
shuffling, epochs, ``drop_remainder``, ``skip_batches``, file sharding,
interleaving, within-list shuffles, bucketed list sizes and decode thread
counts. Every batch must be bitwise equal. A cached epoch must equal the
first, and a corrupt, truncated or unreadable file must raise.
"""

import glob
import os
import time

import numpy as np
import pytest

from ranking_tpu.data import dataset as jax_dataset
from ranking_tpu.data import parsers as jax_parsers
from ranking_tpu_torch.data import dataset
from ranking_tpu_torch.data import native
from ranking_tpu_torch.data import parsers
from ranking_tpu_torch.data import proto
from ranking_tpu_torch.data import tfrecord

F, L, B = 4, 6, 3


def _specs(pkg):
  return ({'qid': pkg.FixedLenFeature((), 'int64', 0)},
          {'float_features': pkg.FixedLenFeature((F,), 'float32', 0.0),
           'relevance': pkg.FixedLenFeature((), 'int64', 0),
           'doc_tokens': pkg.VarLenFeature('string', max_len=2,
                                           hash_buckets=50)})


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
  root = tmp_path_factory.mktemp('elwc')
  rng = np.random.RandomState(0)
  qid = 0
  for name, lists in (('a', 10), ('b', 7), ('c', 5)):
    records = []
    for _ in range(lists):
      n = rng.randint(1, L + 3)  # some lists longer than L: truncated
      docs = [{'float_features': rng.randn(F).astype(np.float32),
               'relevance': [int(rng.randint(0, 5))],
               'doc_tokens': [f't{i}' for i in rng.randint(0, 9, size=2)]}
              for _ in range(n)]
      records.append(proto.make_elwc({'qid': [qid]}, docs))
      qid += 1
    tfrecord.write_records(str(root / f'{name}.tfrecord'), records)
  return str(root / '*.tfrecord')


def _assert_streams_equal(got, want):
  got, want = list(got), list(want)
  assert len(got) == len(want) > 0
  for g, w in zip(got, want):
    for kind in ('context', 'examples'):
      gd, wd = getattr(g, kind), getattr(w, kind)
      assert sorted(gd) == sorted(wd)
      for k in wd:
        assert gd[k].numpy().dtype == np.asarray(wd[k]).dtype, k
        np.testing.assert_array_equal(gd[k].numpy(), np.asarray(wd[k]))
    np.testing.assert_array_equal(g.labels.numpy(), np.asarray(w.labels))
    assert g.labels.numpy().dtype == np.asarray(w.labels).dtype
    np.testing.assert_array_equal(g.mask.numpy(), np.asarray(w.mask))
  return got


_PYTHON_CASES = {
    'plain': dict(shuffle=False),
    'shuffled_two_epochs': dict(epochs=2, shuffle_buffer_size=5, seed=3),
    'keep_remainder': dict(shuffle=False, drop_remainder=False,
                           mask_feature_name='m', size_feature_name='n'),
    'skip': dict(epochs=2, shuffle_buffer_size=4, seed=5, skip_batches=3),
    'shard': dict(shuffle=False, num_shards=2, shard_index=1),
    'interleave': dict(shuffle=False, interleave_files=2),
    'shuffle_examples': dict(seed=7, shuffle_examples=True, skip_batches=1,
                             convert_labels_to_binary=True),
    'bucketed': dict(shuffle=False, list_size=None, drop_remainder=False),
}


@pytest.mark.parametrize('case', sorted(_PYTHON_CASES))
def test_python_stream_matches_jax(corpus, case):
  kw = dict(dict(list_size=L, epochs=1), **_PYTHON_CASES[case])
  jctx, jex = _specs(jax_parsers)
  tctx, tex = _specs(parsers)
  want = jax_dataset.build_ranking_dataset(
      corpus, 'example_list_with_context', B, jctx, jex, **kw)
  got = dataset.build_ranking_dataset(
      corpus, 'example_list_with_context', B, tctx, tex, **kw)
  _assert_streams_equal(got, want)


def test_skip_batches_is_the_tail_of_the_straight_stream(corpus):
  kw = dict(list_size=L, epochs=2, shuffle_buffer_size=4, seed=9,
            shuffle_examples=True)
  tctx, tex = _specs(parsers)
  straight = list(dataset.build_ranking_dataset(
      corpus, 'example_list_with_context', B, tctx, tex, **kw))
  skipped = dataset.build_ranking_dataset(
      corpus, 'example_list_with_context', B, tctx, tex, skip_batches=4,
      **kw)
  _assert_streams_equal(skipped, straight[4:])


_NATIVE_CASES = {
    'plain_one_thread': dict(shuffle=False, num_threads=1),
    'shuffled_three_threads': dict(epochs=2, shuffle_buffer_size=5, seed=3,
                                   num_threads=3),
    'keep_remainder': dict(shuffle=False, drop_remainder=False,
                           size_feature_name='n'),
    'skip': dict(epochs=3, shuffle_buffer_size=4, seed=5, skip_batches=4,
                 num_threads=2),
    'shard': dict(shuffle=False, num_shards=2, shard_index=0),
}


@pytest.mark.parametrize('case', sorted(_NATIVE_CASES))
def test_native_stream_matches_jax(corpus, case):
  kw = dict(dict(list_size=L, epochs=1), **_NATIVE_CASES[case])
  jctx, jex = _specs(jax_parsers)
  tctx, tex = _specs(parsers)
  want = jax_dataset.native_ranking_dataset(
      corpus, B, context_feature_spec=jctx, example_feature_spec=jex, **kw)
  got = dataset.native_ranking_dataset(
      corpus, B, context_feature_spec=tctx, example_feature_spec=tex, **kw)
  _assert_streams_equal(got, want)


def test_thread_counts_and_skips_give_one_stream(corpus):
  tctx, tex = _specs(parsers)

  def stream(**kw):
    return list(dataset.native_ranking_dataset(
        corpus, B, context_feature_spec=tctx, example_feature_spec=tex,
        list_size=L, epochs=2, shuffle_buffer_size=6, seed=11, **kw))

  one = stream(num_threads=1)
  _assert_streams_equal(stream(num_threads=4), one)
  _assert_streams_equal(stream(num_threads=3, skip_batches=5), one[5:])


def test_a_cached_epoch_equals_the_first(corpus, tmp_path):
  """Batches of 2 of the 22 lists: an epoch is 11 batches."""
  tctx, tex = _specs(parsers)
  kw = dict(context_feature_spec=tctx, example_feature_spec=tex,
            list_size=L, shuffle=False, num_threads=2,
            cache_dir=str(tmp_path / 'cache'))
  two = list(dataset.native_ranking_dataset(corpus, 2, epochs=2, **kw))
  assert len(two) == 22
  _assert_streams_equal(two[11:], two[:11])
  assert len(os.listdir(tmp_path / 'cache')) == 1
  # A later run reads the complete spill: the same batches again.
  _assert_streams_equal(
      dataset.native_ranking_dataset(corpus, 2, epochs=1, **kw), two[:11])
  uncached = dict(kw, cache_dir=None)
  _assert_streams_equal(
      dataset.native_ranking_dataset(corpus, 2, epochs=1, **uncached),
      two[:11])
  paths = sorted(glob.glob(corpus))
  loader = native.NativeLoader(
      paths, tctx, tex, 2, L, shuffle=False,
      cache_path=native.cache_file_for(str(tmp_path / 'cache'), paths, tctx,
                                       tex, L))
  assert loader.cache_state == 'read'
  next(loader)
  loader.close()


@pytest.mark.parametrize('case', ['held_by_another_loader', 'unwritable'])
def test_a_cache_that_cannot_be_used_raises(corpus, tmp_path, case):
  """A cache asked for and not usable raises; nothing runs uncached."""
  tctx, tex = _specs(parsers)
  paths = sorted(glob.glob(corpus))
  blocker = (tmp_path / 'file')
  blocker.write_bytes(b'')
  cache_path = (str(tmp_path / 'spill') if case == 'held_by_another_loader'
                else str(blocker / 'spill'))

  def loader():
    return native.NativeLoader(paths, tctx, tex, 2, L, shuffle=False,
                               cache_path=cache_path)

  holder = loader() if case == 'held_by_another_loader' else None
  if holder is not None:
    assert holder.cache_state == 'build'
  with pytest.raises(ValueError, match='dataset cache'):
    loader()
  if holder is not None:
    holder.close()
    # Once the builder has let go, the cache opens again (complete if its
    # threads finished the spill before it closed).
    assert loader().cache_state in ('build', 'read')


_REL = {'relevance': parsers.FixedLenFeature((), 'int64', 0)}
_GOOD = proto.make_elwc({}, [{'relevance': [1]}, {'relevance': [0]}])


def _both_streams(pattern):
  yield lambda: list(dataset.build_ranking_dataset(
      pattern, 'example_list_with_context', 2, {}, _REL, list_size=4,
      shuffle=False))
  yield lambda: list(dataset.native_ranking_dataset(
      pattern, 2, context_feature_spec={}, example_feature_spec=_REL,
      list_size=4, shuffle=False))


def test_corrupt_truncated_and_unreadable_files_raise(tmp_path):
  corrupt = str(tmp_path / 'corrupt.tfrecord')
  tfrecord.write_records(corrupt, [_GOOD, b'\xff\xfe not a proto \x00\x01'])
  for run in _both_streams(corrupt):
    with pytest.raises(ValueError):
      run()
  good = str(tmp_path / 'good.tfrecord')
  tfrecord.write_records(good, [_GOOD] * 4)
  truncated = tmp_path / 'truncated.tfrecord'
  truncated.write_bytes(open(good, 'rb').read()[:-7])
  for run in _both_streams(str(truncated)):
    with pytest.raises((IOError, ValueError)):
      run()
  loader = native.NativeLoader([good, str(tmp_path / 'gone.tfrecord')], {},
                               _REL, batch_size=2, list_size=4,
                               shuffle=False, epochs=1)
  with pytest.raises(ValueError, match='unreadable'):
    list(loader)


@pytest.mark.parametrize('engine', ['python', 'native'])
def test_a_repeated_stream_over_no_record_raises(tmp_path, engine):
  """Over a file with no record, one epoch is an empty stream, and more
  raise at once instead of looking for a record forever."""
  empty = tmp_path / 'empty.tfrecord'
  empty.write_bytes(b'')

  def stream(epochs):
    if engine == 'python':
      return dataset.build_ranking_dataset(
          str(empty), 'example_list_with_context', 2, {}, _REL, list_size=4,
          shuffle=False, epochs=epochs)
    return dataset.native_ranking_dataset(
        str(empty), 2, context_feature_spec={}, example_feature_spec=_REL,
        list_size=4, shuffle=False, epochs=epochs)

  assert list(stream(1)) == []
  for epochs in (None, 3):
    batches = stream(epochs)
    start = time.monotonic()
    with pytest.raises(ValueError, match='empty.tfrecord'):
      next(batches)
    assert time.monotonic() - start < 1
