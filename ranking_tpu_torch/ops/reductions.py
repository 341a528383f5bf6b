"""Weighted loss reductions with TF-parity semantics.

The port's copy of ``ranking_tpu/ops/reductions.py``: the reduction modes
of ``tf.compat.v1.losses.compute_weighted_loss`` (the layer behind every
loss in the reference, tensorflow_ranking/python/losses_impl.py:813). The
default is ``SUM_BY_NONZERO_WEIGHTS``: the sum of weighted losses divided
by the number of non-zero weights (python/losses.py:270).

``reduce_terms`` returns the (numerator, denominator) pair, so that
data-parallel training can all-reduce both before dividing.
"""

from __future__ import annotations

import enum
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


class Reduction(str, enum.Enum):
  """How to reduce a tensor of weighted losses to a scalar."""

  NONE = 'none'
  SUM = 'sum'
  MEAN = 'mean'  # sum(w * l) / sum(w)
  SUM_OVER_BATCH_SIZE = 'sum_over_batch_size'
  SUM_BY_NONZERO_WEIGHTS = 'sum_by_nonzero_weights'


def _broadcast(losses: Tensor, weights) -> Tuple[Tensor, Tensor]:
  weights = torch.as_tensor(weights, dtype=losses.dtype, device=losses.device)
  shape = torch.broadcast_shapes(losses.shape, weights.shape)
  return losses.expand(shape), weights.expand(shape)


def reduce_terms(
    losses: Tensor,
    weights: Optional[Tensor],
    reduction: Reduction,
) -> Tuple[Tensor, Tensor]:
  """The (numerator, denominator) of the reduced loss."""
  reduction = Reduction(reduction)
  if weights is None:
    weights = torch.ones_like(losses)
  losses, weights = _broadcast(losses, weights)
  weighted = losses * weights
  numerator = torch.sum(weighted)

  if reduction == Reduction.SUM:
    return numerator, torch.ones_like(numerator)
  if reduction == Reduction.MEAN:
    return numerator, torch.sum(weights)
  if reduction == Reduction.SUM_OVER_BATCH_SIZE:
    return numerator, torch.full_like(numerator, weighted.numel())
  if reduction == Reduction.SUM_BY_NONZERO_WEIGHTS:
    return numerator, torch.sum((weights != 0).to(losses.dtype))
  raise ValueError(f'Reduction {reduction} has no scalar terms.')


def reduce_weighted(
    losses: Tensor,
    weights: Optional[Tensor],
    reduction: Reduction = Reduction.SUM_BY_NONZERO_WEIGHTS,
) -> Tensor:
  """Reduces weighted losses to a scalar (elementwise for NONE)."""
  reduction = Reduction(reduction)
  if reduction == Reduction.NONE:
    if weights is None:
      return losses
    losses, weights = _broadcast(losses, weights)
    return losses * weights
  numerator, denominator = reduce_terms(losses, weights, reduction)
  if reduction == Reduction.SUM:
    return numerator
  return torch.where(denominator > 0,
                     numerator / torch.clamp(denominator, min=1e-38),
                     torch.zeros_like(numerator))
