"""The shared batch data model, on tensors.

The port's copy of ``ranking_tpu/data/batch.py`` (the reference's
feature-dict convention, tensorflow_ranking/python/data.py:41,207): context
features ``[B, ...]``, example (per-document) features ``[B, L, ...]``,
labels ``[B, L]`` with -1.0 padding, and a boolean mask ``[B, L]``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Optional

import torch

Tensor = torch.Tensor


@dataclasses.dataclass
class RankingBatch:
  """One batch: dicts of tensors, labels and a validity mask."""

  context: Dict[str, Tensor]   # each [B, ...]
  examples: Dict[str, Tensor]  # each [B, L, ...] (or flat [B*L, ...])
  labels: Tensor               # [B, L] float, padding -1.0 (or {task: ...})
  mask: Tensor                 # [B, L] bool

  @property
  def features(self) -> Dict[str, Tensor]:
    """Merged view for weight-feature lookup; an examples feature shadows
    a same-named context feature."""
    return {**self.context, **self.examples}

  @property
  def batch_size(self) -> int:
    return self.mask.shape[0]

  @property
  def list_size(self) -> int:
    return self.mask.shape[1]

  def replace(self, **changes) -> 'RankingBatch':
    return dataclasses.replace(self, **changes)

  def to(self, device) -> 'RankingBatch':
    """The batch with every tensor on ``device`` (no copy where it is)."""
    return RankingBatch(
        context={k: v.to(device) for k, v in self.context.items()},
        examples={k: v.to(device) for k, v in self.examples.items()},
        labels=({k: v.to(device) for k, v in self.labels.items()}
                if isinstance(self.labels, dict) else self.labels.to(device)),
        mask=self.mask.to(device))

  def pad_to(self, batch_size: int) -> 'RankingBatch':
    """Pads the batch axis with fully-masked rows up to ``batch_size``.

    Padded rows carry labels -1, mask False and zero features, so every
    mask-aware metric weights them zero. The eval loop uses it to keep a
    finite split's final partial batch at the batch shape; pass
    ``num_valid_rows`` to the eval step so the padding rows also get zero
    metric weight.
    """
    pad = batch_size - self.batch_size
    if pad <= 0:
      return self

    def _pad(a: Tensor, fill=0) -> Tensor:
      return torch.cat([a, torch.full((pad,) + tuple(a.shape[1:]), fill,
                                      dtype=a.dtype, device=a.device)])

    return RankingBatch(
        context={k: _pad(v) for k, v in self.context.items()},
        examples={k: _pad(v) for k, v in self.examples.items()},
        labels=_pad(self.labels, -1.0),
        mask=_pad(self.mask, False))


def batch_from_labels(
    labels,
    context: Optional[Mapping[str, object]] = None,
    examples: Optional[Mapping[str, object]] = None,
    mask=None,
) -> RankingBatch:
  """Builds a batch from arrays or tensors; mask defaults to labels >= 0."""
  labels = torch.as_tensor(labels)
  mask = labels >= 0 if mask is None else torch.as_tensor(mask).to(torch.bool)
  return RankingBatch(
      context={k: torch.as_tensor(v) for k, v in (context or {}).items()},
      examples={k: torch.as_tensor(v) for k, v in (examples or {}).items()},
      labels=labels,
      mask=mask)


def stack_numpy_batches(batches: Iterable[RankingBatch],
                        pin_memory: bool = False) -> RankingBatch:
  """K host batches of one shape as one batch with a leading steps axis.

  Leaves may be numpy arrays or tensors. With ``pin_memory`` each stacked
  leaf is written straight into page-locked host memory, from which one
  asynchronous copy moves the K batches to the card.
  """
  batches = list(batches)
  if not batches:
    raise ValueError('no batches to stack (empty stream?)')

  def stack(items):
    items = [torch.as_tensor(x) for x in items]
    out = torch.empty((len(items),) + tuple(items[0].shape),
                      dtype=items[0].dtype, pin_memory=pin_memory)
    return torch.stack(items, out=out)

  first = batches[0]
  return RankingBatch(
      context={k: stack([b.context[k] for b in batches])
               for k in first.context},
      examples={k: stack([b.examples[k] for b in batches])
                for k in first.examples},
      labels=({k: stack([b.labels[k] for b in batches])
               for k in first.labels} if isinstance(first.labels, dict)
              else stack([b.labels for b in batches])),
      mask=stack([b.mask for b in batches]))
