"""Host-side batch layout.

The port's copy of ``flatten_examples`` from ``ranking_tpu/data/dataset.py``.
"""

from __future__ import annotations

from ranking_tpu_torch.data.batch import RankingBatch


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
