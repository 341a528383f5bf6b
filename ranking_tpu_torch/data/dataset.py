"""The host feed: in-memory batches, the flat layout and the device copy.

The port's copy of ``in_memory_batches``, ``flatten_examples`` and
``prefetch_to_device`` from ``ranking_tpu/data/dataset.py``. On CUDA the
prefetch copies from page-locked host memory on a side stream, so that the
copy of the next batches overlaps the steps on the current one.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ranking_tpu_torch.data.batch import RankingBatch
from ranking_tpu_torch.utils.device import DeviceLike, resolve_device


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
  """
  n = features.shape[0]
  rng = np.random.RandomState(seed)
  epoch = 0
  while epochs is None or epoch < epochs:
    order = rng.permutation(n) if shuffle else np.arange(n)
    for start in range(0, n, batch_size):
      idx = order[start:start + batch_size]
      if len(idx) < batch_size and drop_remainder:
        break
      lab = torch.from_numpy(labels[idx])
      yield RankingBatch(
          context={},
          examples={feature_name: torch.from_numpy(features[idx])},
          labels=lab,
          mask=lab >= 0)
    epoch += 1


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
