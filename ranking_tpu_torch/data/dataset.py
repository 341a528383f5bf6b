"""The host feed: TFRecord streams, in-memory batches, the flat layout and
the device copy.

The port's copy of ``ranking_tpu/data/dataset.py``. The reference's
tf.data pipeline (tensorflow_ranking/python/data.py:914-1017: list_files ->
interleave -> repeat -> shuffle -> batch -> parse -> prefetch) is here in
two engines with one batch contract: ``build_ranking_dataset``, a Python
record stream with an epoch-aware shuffle buffer whose batches go through
``parsers.parse`` (the native decoder where it takes the specs), and
``native_ranking_dataset``, where the C++ loader (``data/native``) owns
reading, shuffling, decoding and batching, with a decoded-once epoch
cache. ``in_memory_batches`` batches pre-loaded arrays (the LIBSVM path).
On CUDA ``prefetch_to_device`` copies from page-locked host memory on a
side stream, so that the copy of the next batches overlaps the steps on
the current one.
"""

from __future__ import annotations

import glob as glob_lib
from typing import (Iterable, Iterator, List, Mapping, Optional, Tuple,
                    Union)

import numpy as np
import torch

from ranking_tpu_torch.data import parsers, tfrecord
from ranking_tpu_torch.data.batch import RankingBatch
from ranking_tpu_torch.data.parsers import FeatureSpec, ParsedLists
from ranking_tpu_torch.utils.device import DeviceLike, resolve_device


def _records_stream(paths: List[str], epochs: Optional[int],
                    shuffle_files: bool,
                    rng: np.random.RandomState,
                    interleave_files: int = 1) -> Iterator[bytes]:
  """File walk with an optional cycle interleave: up to
  ``interleave_files`` readers are open at once and records round-robin
  across them (the list_files -> interleave of python/data.py:941-960).
  A pass that yields no record raises ``ValueError`` when more passes are
  asked for, where it would otherwise repeat forever."""
  epoch = 0
  while epochs is None or epoch < epochs:
    order = list(paths)
    if shuffle_files:
      rng.shuffle(order)
    empty = True
    for record in _one_pass(order, interleave_files):
      empty = False
      yield record
    epoch += 1
    if empty and (epochs is None or epoch < epochs):
      raise ValueError(f'{paths} hold no record: a repeated stream over '
                       'them would never yield one')


def _one_pass(order: List[str], interleave_files: int) -> Iterator[bytes]:
  if interleave_files <= 1:
    for p in order:
      yield from tfrecord.read_records(p)
    return
  pending = list(order)
  readers: List[Iterator[bytes]] = []
  while pending or readers:
    while pending and len(readers) < interleave_files:
      readers.append(tfrecord.read_records(pending.pop(0)))
    i = 0
    while i < len(readers):
      try:
        yield next(readers[i])
        i += 1
      except StopIteration:
        readers.pop(i)
        if pending:
          readers.append(tfrecord.read_records(pending.pop(0)))


def _shuffled(stream: Iterator[bytes], buffer_size: int,
              rng: np.random.RandomState) -> Iterator[bytes]:
  if buffer_size <= 1:
    yield from stream
    return
  buf: List[bytes] = []
  for rec in stream:
    buf.append(rec)
    if len(buf) >= buffer_size:
      i = rng.randint(len(buf))
      buf[i], buf[-1] = buf[-1], buf[i]
      yield buf.pop()
  rng.shuffle(buf)
  yield from buf


def _batched(stream: Iterator[bytes], batch_size: int,
             drop_remainder: bool) -> Iterator[List[bytes]]:
  batch: List[bytes] = []
  for rec in stream:
    batch.append(rec)
    if len(batch) == batch_size:
      yield batch
      batch = []
  if batch and not drop_remainder:
    yield batch


def parsed_to_batch(
    parsed: ParsedLists,
    label_feature_name: Union[str, Mapping[str, str]],
    convert_labels_to_binary: bool = False,
    mask_feature_name: Optional[str] = None,
    size_feature_name: Optional[str] = None,
) -> RankingBatch:
  """ParsedLists -> a RankingBatch of CPU tensors: pops the label
  feature(s) out of the example features, squeezes each to [B, L], puts -1
  on padded slots (python/data.py:41), binarizes on request
  (keras/pipeline.py:1026-1117) and exposes the mask and size features on
  request (python/data.py:99-130). A dict ``label_feature_name`` (task ->
  feature) gives dict labels. The arithmetic is numpy's, as in the JAX
  package; the tensors share the arrays' memory."""
  examples = dict(parsed.examples)

  def _pop_label(name: str) -> np.ndarray:
    labels = examples.pop(name).astype(np.float32)
    labels = labels.reshape(labels.shape[0], labels.shape[1])
    if convert_labels_to_binary:
      labels = np.where(labels > 0, 1.0, np.where(labels >= 0, 0.0, labels))
    return np.where(parsed.mask, labels, parsers.PADDING_LABEL)

  if isinstance(label_feature_name, str):
    labels = _pop_label(label_feature_name)
  else:
    labels = {task: _pop_label(name)
              for task, name in label_feature_name.items()}

  context = dict(parsed.context)
  mask = parsed.mask
  if size_feature_name:
    context[size_feature_name] = parsed.sizes.astype(np.int32)
  if mask_feature_name:
    examples[mask_feature_name] = mask
  return RankingBatch(
      context={k: torch.from_numpy(v) for k, v in context.items()},
      examples={k: torch.from_numpy(v) for k, v in examples.items()},
      labels=({k: torch.from_numpy(v) for k, v in labels.items()}
              if isinstance(labels, dict) else torch.from_numpy(labels)),
      mask=torch.from_numpy(mask))


def _shard_paths(paths: List[str], shard_index: Optional[int],
                 num_shards: Optional[int], file_pattern: str) -> List[str]:
  """Input sharding over processes: each reads a disjoint subset of the
  files. ``shard_index`` defaults to the ``torch.distributed`` rank when a
  process group is up, else to 0."""
  if not num_shards:
    return paths
  if shard_index is None:
    dist = torch.distributed
    shard_index = (dist.get_rank() if dist.is_available()
                   and dist.is_initialized() else 0)
  if not 0 <= shard_index < num_shards:
    raise ValueError(f'shard_index {shard_index} out of range for '
                     f'num_shards={num_shards}')
  paths = paths[shard_index::num_shards]
  if not paths:
    raise ValueError(
        f'shard {shard_index}/{num_shards} got no files; need at least '
        f'{num_shards} files matching {file_pattern!r}')
  return paths


def _paths(file_pattern: str, shard_index, num_shards) -> List[str]:
  paths = sorted(glob_lib.glob(file_pattern))
  if not paths:
    raise FileNotFoundError(f'No files match {file_pattern!r}')
  return _shard_paths(paths, shard_index, num_shards, file_pattern)


def build_ranking_dataset(
    file_pattern: str,
    data_format: str,
    batch_size: int,
    context_feature_spec: Mapping[str, FeatureSpec],
    example_feature_spec: Mapping[str, FeatureSpec],
    label_feature_name: str = 'relevance',
    list_size: Optional[int] = None,
    convert_labels_to_binary: bool = False,
    epochs: Optional[int] = 1,
    shuffle: bool = True,
    shuffle_buffer_size: int = 1000,
    shuffle_examples: bool = False,
    drop_remainder: bool = True,
    mask_feature_name: Optional[str] = None,
    size_feature_name: Optional[str] = None,
    seed: Optional[int] = None,
    shard_index: Optional[int] = None,
    num_shards: Optional[int] = None,
    interleave_files: int = 1,
    skip_batches: int = 0,
) -> Iterator[RankingBatch]:
  """Streams RankingBatches from TFRecord files of ranking protos, in the
  JAX package's batch order: one ``np.random.RandomState(seed)`` draws the
  file order of each epoch, the shuffle buffer's picks and the per-batch
  seeds of ``shuffle_examples``, in the same sequence. Each batch parses
  through ``parsers.parse`` (the native decoder where it takes the specs),
  or through the plain parser with ``shuffle_examples``, which only it
  has. ``list_size=None`` pads each ELWC batch to its longest list rounded
  up ``parsers.bucket_list_size``'s ladder.

  The arguments are checked when this is called; the files are read as the
  stream is consumed, in the consumer's thread (a parse that holds the
  interpreter lock gains nothing from a pool). ``drop_remainder`` defaults
  to True here; the reference drops the final partial batch only on
  repeated streams (python/data.py:1008), a rule the dataset builder
  applies. ``skip_batches`` drops the leading record batches unparsed, and
  still makes their random draws, so that the stream goes on bitwise as
  ``batches[skip_batches:]`` of an unskipped one.
  """
  if data_format not in parsers.PARSER_FNS:
    raise ValueError(f'Unknown data_format {data_format!r}; '
                     f'one of {sorted(parsers.PARSER_FNS)}')
  if list_size is None and data_format != 'example_list_with_context':
    # Bucketed list sizes need the cheap length probe, which exists for
    # ELWC only (parsers.elwc_list_sizes).
    raise ValueError(
        'list_size=None (bucketed dynamic list sizes) is supported for '
        "data_format='example_list_with_context' only; set an explicit "
        'list_size for other formats')
  paths = _paths(file_pattern, shard_index, num_shards)
  if shuffle_examples and data_format not in (
      'example_list_with_context', 'example_in_example'):
    raise ValueError(
        f'shuffle_examples is not supported for {data_format!r} '
        '(the parser has no within-list shuffle); it would be a silent '
        'no-op')
  rng = np.random.RandomState(seed)

  def _parse(records: List[bytes], shuffle_seed: Optional[int]
             ) -> RankingBatch:
    batch_list_size = list_size or parsers.bucket_list_size(
        parsers.elwc_list_sizes(records).max())
    if shuffle_examples:
      parsed = parsers.PARSER_FNS[data_format](
          records, context_feature_spec, example_feature_spec,
          list_size=batch_list_size, shuffle_examples=True,
          rng=np.random.RandomState(shuffle_seed))
    else:
      parsed = parsers.parse(records, context_feature_spec,
                             example_feature_spec, batch_list_size,
                             data_format=data_format)
    return parsed_to_batch(
        parsed, label_feature_name,
        convert_labels_to_binary=convert_labels_to_binary,
        mask_feature_name=mask_feature_name,
        size_feature_name=size_feature_name)

  def _stream():
    stream = _records_stream(paths, epochs, shuffle, rng,
                             interleave_files=interleave_files)
    if shuffle:
      stream = _shuffled(stream, shuffle_buffer_size, rng)
    for index, records in enumerate(_batched(stream, batch_size,
                                             drop_remainder)):
      # The per-batch seed is drawn for skipped batches too, so that the
      # shared generator's sequence is that of an unskipped stream.
      seed_i = (int(rng.randint((1 << 31) - 1)) if shuffle_examples
                else None)
      if index >= skip_batches:
        yield _parse(records, seed_i)

  return _stream()


def native_ranking_dataset(
    file_pattern: str,
    batch_size: int,
    *,
    data_format: str = 'example_list_with_context',
    context_feature_spec: Mapping[str, FeatureSpec],
    example_feature_spec: Mapping[str, FeatureSpec],
    label_feature_name: str = 'relevance',
    list_size: Optional[int] = None,
    convert_labels_to_binary: bool = False,
    epochs: Optional[int] = 1,
    shuffle: bool = True,
    shuffle_buffer_size: int = 1000,
    drop_remainder: bool = True,
    mask_feature_name: Optional[str] = None,
    size_feature_name: Optional[str] = None,
    seed: Optional[int] = None,
    num_threads: Optional[int] = None,
    shard_index: Optional[int] = None,
    num_shards: Optional[int] = None,
    skip_batches: int = 0,
    cache_dir: Optional[str] = None,
) -> Iterator[RankingBatch]:
  """ELWC or SequenceExample stream driven by the C++ loader
  (``native.NativeLoader``): the batch contract of
  ``build_ranking_dataset``, in the JAX native stream's order, bitwise the
  same for every ``num_threads`` (default min(8, cpus)). ``skip_batches``
  drops the leading record batches undecoded. ``cache_dir`` turns on the
  decoded-once epoch cache: the first pass decodes each record once into
  a spill file there (named by ``native.cache_file_for``), later epochs
  and runs read decoded payloads, and the batches are bitwise those of an
  uncached stream. The specs are checked, and the loader is started and
  its cache opened, when this is called."""
  from ranking_tpu_torch.data import native
  paths = _paths(file_pattern, shard_index, num_shards)
  if list_size is None:
    raise ValueError('native loader requires a fixed list_size')
  cache_path = None
  if cache_dir is not None:
    cache_path = native.cache_file_for(
        cache_dir, paths, context_feature_spec, example_feature_spec,
        list_size, data_format=data_format)
  loader = native.NativeLoader(
      paths, context_feature_spec, example_feature_spec,
      batch_size=batch_size, list_size=list_size, shuffle=shuffle,
      shuffle_buffer=shuffle_buffer_size, epochs=epochs,
      drop_remainder=drop_remainder, seed=seed or 0,
      data_format=data_format, num_threads=num_threads,
      skip_batches=skip_batches, cache_path=cache_path)
  return NativeBatches(loader, label_feature_name=label_feature_name,
                       convert_labels_to_binary=convert_labels_to_binary,
                       mask_feature_name=mask_feature_name,
                       size_feature_name=size_feature_name)


class NativeBatches:
  """The stream of ``native_ranking_dataset``: its loader's batches as
  RankingBatches. ``loader`` tells its thread count and cache state; the
  loader closes itself at the end of its stream or on an error, and
  ``close`` ends it early."""

  def __init__(self, loader, **batch_kwargs):
    self.loader = loader
    self._batch_kwargs = batch_kwargs

  def __iter__(self):
    return self

  def __next__(self) -> RankingBatch:
    parsed = next(self.loader)
    try:
      return parsed_to_batch(parsed, **self._batch_kwargs)
    except Exception:
      self.close()
      raise

  def close(self):
    self.loader.close()


def in_memory_batches(
    features: np.ndarray,
    labels: np.ndarray,
    batch_size: int,
    feature_name: str = 'float_features',
    epochs: Optional[int] = 1,
    shuffle: bool = True,
    seed: Optional[int] = None,
    drop_remainder: bool = True,
) -> Iterator[RankingBatch]:
  """Batches pre-loaded listwise arrays (the LIBSVM path), as CPU tensors.

  The order comes from ``np.random.RandomState(seed)`` as in the JAX
  package, so that both packages see the same batches in the same order.
  A pass that yields no batch (no lists, or fewer than ``batch_size``
  under ``drop_remainder``) raises ``ValueError`` when more passes are
  asked for, where it would otherwise repeat forever.
  """
  n = features.shape[0]
  rng = np.random.RandomState(seed)
  epoch = 0
  while epochs is None or epoch < epochs:
    order = rng.permutation(n) if shuffle else np.arange(n)
    empty = True
    for start in range(0, n, batch_size):
      idx = order[start:start + batch_size]
      if len(idx) < batch_size and drop_remainder:
        break
      empty = False
      lab = torch.from_numpy(labels[idx])
      yield RankingBatch(
          context={},
          examples={feature_name: torch.from_numpy(features[idx])},
          labels=lab,
          mask=lab >= 0)
    epoch += 1
    if empty and (epochs is None or epoch < epochs):
      raise ValueError(
          f'{n} lists make no batch of {batch_size} with drop_remainder='
          f'{drop_remainder}: a repeated stream would never yield one')


def flatten_examples(batch: RankingBatch) -> RankingBatch:
  """Flat feed layout: ``[B, L, F...]`` example features -> ``[B*L, F...]``.

  The step restores the listwise view (``train.steps.restore_flat_examples``);
  on a tensor in row-major memory both layouts are the same bytes, so the
  pair costs two views. Only rank >= 3 example features flatten; labels,
  mask and context are untouched, and L == 1 batches pass through.
  """
  b, l = batch.mask.shape
  if l <= 1:
    return batch
  examples = {
      k: (v.reshape((b * l,) + tuple(v.shape[2:]))
          if v.ndim >= 3 and tuple(v.shape[:2]) == (b, l) else v)
      for k, v in batch.examples.items()}
  return batch.replace(examples=examples)


def _tensors(batch: RankingBatch) -> List[torch.Tensor]:
  labels = (list(batch.labels.values()) if isinstance(batch.labels, dict)
            else [batch.labels])
  return (list(batch.context.values()) + list(batch.examples.values())
          + labels + [batch.mask])


def prefetch_to_device(
    batches: Iterable[RankingBatch],
    device: DeviceLike = 'cuda',
    buffer_size: int = 2,
    flat_examples: bool = False,
) -> Iterator[RankingBatch]:
  """Copies batches to ``device`` up to ``buffer_size`` ahead of the consumer.

  On CUDA each batch is put in page-locked host memory and copied on a side
  stream; an event releases it to the consumer's stream, which waits for
  the copy before any work it queues after the yield, and ``record_stream``
  keeps the allocator from reusing its memory while that work runs. On the
  CPU the batches pass through as they are. ``flat_examples=True`` applies
  :func:`flatten_examples` first.
  """
  device = resolve_device(device)
  if flat_examples:
    batches = (flatten_examples(b) for b in batches)
  if device.type != 'cuda':
    return iter(batches)
  return _prefetch_cuda(iter(batches), device, buffer_size)


def _prefetch_cuda(it: Iterator[RankingBatch], device: torch.device,
                   buffer_size: int) -> Iterator[RankingBatch]:
  copy_stream = torch.cuda.Stream(device)

  def put(batch: RankingBatch) -> Tuple[RankingBatch, torch.cuda.Event]:
    pinned = batch.to('cpu')
    pinned = _map(pinned, lambda t: t if t.is_pinned() else t.pin_memory())
    with torch.cuda.stream(copy_stream):
      out = _map(pinned, lambda t: t.to(device, non_blocking=True))
      done = torch.cuda.Event()
      done.record(copy_stream)
    return out, done

  def release(item: Tuple[RankingBatch, torch.cuda.Event]) -> RankingBatch:
    out, done = item
    stream = torch.cuda.current_stream(device)
    stream.wait_event(done)
    for t in _tensors(out):
      t.record_stream(stream)
    return out

  buf = []
  for batch in it:
    buf.append(put(batch))
    if len(buf) > buffer_size:
      yield release(buf.pop(0))
  while buf:
    yield release(buf.pop(0))


def _map(batch: RankingBatch, fn) -> RankingBatch:
  return RankingBatch(
      context={k: fn(v) for k, v in batch.context.items()},
      examples={k: fn(v) for k, v in batch.examples.items()},
      labels=({k: fn(v) for k, v in batch.labels.items()}
              if isinstance(batch.labels, dict) else fn(batch.labels)),
      mask=fn(batch.mask))
