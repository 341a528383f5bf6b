"""Ranking losses as pure, masking-aware functions on tensors.

The port's copy of the softmax and pairwise parts of
``ranking_tpu/ops/losses.py`` (the reference's
tensorflow_ranking/python/losses_impl.py). Losses are frozen dataclasses
with pure methods:

* ``unreduced(labels, logits, mask, generator) -> (losses, loss_weights)``
* ``normalize_weights(labels, weights)``: the family's weight semantics
* ``__call__(labels, logits, weights, mask, reduction, generator) -> scalar``
* ``per_list(...) -> ([B] losses, [B] weights)`` for loss-as-metric streams

``labels`` and ``logits`` are ``[B, L]`` float32, the padding label is -1
and ``mask = labels >= 0`` when not given. ``generator`` (the JAX package's
``key``) shuffles rank ties under a lambda weight; None is deterministic.
Ported so far: ``SoftmaxLoss`` and the four pairwise losses; the other
losses of the zoo raise "not ported yet" in ``ops/loss_registry.py``.

The O(L^2) pairwise tensors formed here are the semantic source of truth,
and the only path on the CPU; on the card the fused kernels of
``ops/cuda/pairwise.py`` compute the same sums without a ``[B, L, L]``
tensor in memory.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ranking_tpu_torch.ops import lambda_weights as lw
from ranking_tpu_torch.ops import sorting
from ranking_tpu_torch.ops.reductions import Reduction, reduce_weighted
from ranking_tpu_torch.utils import list_ops

Tensor = torch.Tensor

EPSILON = 1e-10
LOG_EPSILON = math.log(EPSILON)


def _float(x, like: Optional[Tensor] = None) -> Tensor:
  device = None if like is None else like.device
  return torch.as_tensor(x, device=device).to(torch.float32)


def _pairwise(op, t: Tensor) -> Tensor:
  return op(t[:, :, None], t[:, None, :])


def pairwise_comparison(labels: Tensor, logits: Tensor, mask: Tensor):
  """Pairwise preference labels and logit differences.

  Returns ``(pairwise_labels, pairwise_logits)``, both ``[B, L, L]``:
  ``pairwise_labels[b, i, j] = I[l_i > l_j and both valid]`` and
  ``pairwise_logits[b, i, j] = s_i - s_j`` (losses_impl.py:503-537).
  """
  pairwise_label_diff = _pairwise(torch.sub, labels)
  pairwise_logits = _pairwise(torch.sub, logits)
  pairwise_labels = (pairwise_label_diff > 0).to(torch.float32)
  valid_pair = _pairwise(torch.logical_and, mask.to(torch.bool))
  return pairwise_labels * valid_pair.to(torch.float32), pairwise_logits


def softmax_cross_entropy(label_dist: Tensor, logits: Tensor) -> Tensor:
  """Per-row CE between a label distribution and softmax(logits)."""
  return -torch.sum(label_dist * torch.log_softmax(logits, dim=-1), dim=-1)


def _label_distribution(labels: Tensor, mask: Optional[Tensor]):
  """Masked per-list label distribution with the reference's EPSILON
  padding for all-zero lists (losses_impl.py:1122-1137). Returns
  ``(label_dist, label_sum)``."""
  if mask is None:
    mask = list_ops.is_label_valid(labels)
  label_sum = torch.sum(labels, dim=1, keepdim=True)
  nonzero = label_sum > 0.0
  padded_labels = torch.where(nonzero, labels, EPSILON)
  padded_labels = torch.where(mask, padded_labels, 0.0)
  padded_sum = torch.sum(padded_labels, dim=1, keepdim=True)
  label_dist = torch.where(padded_sum > 0,
                           padded_labels / torch.clamp(padded_sum, min=1e-38),
                           0.0)
  return label_dist, label_sum


@dataclasses.dataclass(frozen=True)
class RankingLoss:
  """Base ranking loss; see the module docstring."""

  name: str = ''
  lambda_weight: Optional[lw.LambdaWeight] = None
  temperature: float = 1.0

  def unreduced(self, labels, logits, mask=None, generator=None):
    raise NotImplementedError

  def normalize_weights(self, labels: Tensor, weights):
    del labels
    return 1.0 if weights is None else weights

  def get_logits(self, logits: Tensor) -> Tensor:
    return logits / self.temperature

  def __call__(self, labels, logits, weights=None, mask=None,
               reduction: Reduction = Reduction.SUM_BY_NONZERO_WEIGHTS,
               generator: Optional[torch.Generator] = None) -> Tensor:
    """Reduced scalar loss (losses_impl.py:787-814)."""
    logits = self.get_logits(_float(logits))
    labels = _float(labels, logits)
    losses, loss_weights = self.unreduced(labels, logits, mask=mask,
                                          generator=generator)
    weights = self.normalize_weights(labels, weights) * loss_weights
    return reduce_weighted(losses, weights, reduction)

  def per_list(self, labels, logits, weights=None, mask=None, generator=None):
    raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class _PairwiseLoss(RankingLoss):
  """Pairwise family: loss on s_i - s_j for preference pairs l_i > l_j."""

  def _pairwise_loss(self, pairwise_logits: Tensor) -> Tensor:
    raise NotImplementedError

  def __call__(self, labels, logits, weights=None, mask=None,
               reduction: Reduction = Reduction.SUM_BY_NONZERO_WEIGHTS,
               generator: Optional[torch.Generator] = None) -> Tensor:
    # The fused kernels first (pair matrices never in memory); the
    # [B, L, L] path below for the configurations they do not take.
    from ranking_tpu_torch.ops.cuda import pairwise as cuda_pairwise
    fused = cuda_pairwise.maybe_fused_pairwise(
        self, labels, logits, weights, mask, reduction, generator)
    if fused is not None:
      return fused
    return super().__call__(labels, logits, weights=weights, mask=mask,
                            reduction=reduction, generator=generator)

  def unreduced(self, labels, logits, mask=None, generator=None):
    if mask is None:
      mask = list_ops.is_label_valid(labels)
    pairwise_labels, pairwise_logits = pairwise_comparison(
        labels, logits, mask)
    pairwise_weights = pairwise_labels
    if self.lambda_weight is not None:
      ranks = sorting.compute_ranks(logits, mask, generator=generator)
      pairwise_weights = pairwise_weights * self.lambda_weight.pair_weights(
          labels, ranks)
    return self._pairwise_loss(pairwise_logits), pairwise_weights.detach()

  def normalize_weights(self, labels, weights):
    # Item weight w_i applies to every pair (i, j): expand on the left axis.
    if weights is None:
      weights = 1.0
    weights = torch.where(list_ops.is_label_valid(labels),
                          torch.ones_like(labels) * weights, 0.0)
    return weights[:, :, None]

  def per_list(self, labels, logits, weights=None, mask=None, generator=None):
    logits = self.get_logits(_float(logits))
    labels = _float(labels, logits)
    losses, loss_weights = self.unreduced(labels, logits, mask=mask,
                                          generator=generator)
    weights = self.normalize_weights(labels, weights) * loss_weights
    per_list_weights = torch.sum(weights, dim=(1, 2))
    per_list_losses = torch.sum(losses * weights, dim=(1, 2))
    per_list_losses = torch.where(
        per_list_weights > 0,
        per_list_losses / torch.clamp(per_list_weights, min=1e-38), 0.0)
    return per_list_losses, per_list_weights


@dataclasses.dataclass(frozen=True)
class PairwiseLogisticLoss(_PairwiseLoss):
  """log(1 + exp(-(s_i - s_j))) on preference pairs."""

  def _pairwise_loss(self, pairwise_logits: Tensor) -> Tensor:
    return (torch.maximum(-pairwise_logits, torch.zeros_like(pairwise_logits))
            + torch.log1p(torch.exp(-torch.abs(pairwise_logits))))


@dataclasses.dataclass(frozen=True)
class PairwiseHingeLoss(_PairwiseLoss):
  """max(0, 1 - (s_i - s_j)) on preference pairs."""

  def _pairwise_loss(self, pairwise_logits: Tensor) -> Tensor:
    # torch.maximum splits the gradient of a tie evenly, as jnp.maximum
    # does: -0.5 at the hinge point (relu and clamp would give 0 or -1).
    return torch.maximum(1.0 - pairwise_logits,
                         torch.zeros_like(pairwise_logits))


@dataclasses.dataclass(frozen=True)
class PairwiseSoftZeroOneLoss(_PairwiseLoss):
  """1 - sigmoid(s_i - s_j): a smooth, bounded zero-one surrogate."""

  def _pairwise_loss(self, pairwise_logits: Tensor) -> Tensor:
    # sigmoid(-x) == 1 - sigmoid(x), computed in the stable direction.
    return torch.sigmoid(-pairwise_logits)


@dataclasses.dataclass(frozen=True)
class PairwiseMSELoss(_PairwiseLoss):
  """((s_i - s_j) - (l_i - l_j))^2 over all valid non-diagonal pairs.

  Unlike the other pairwise losses this one is computed on *all* pairs
  (including equal labels) except self-pairs (losses_impl.py:961-998).
  """

  def _pairwise_loss(self, pairwise_logits: Tensor) -> Tensor:
    raise NotImplementedError  # unreduced() is self-contained.

  def unreduced(self, labels, logits, mask=None, generator=None):
    if mask is None:
      mask = list_ops.is_label_valid(labels)
    pairwise_label_diff = _pairwise(torch.sub, labels)
    pairwise_logit_diff = _pairwise(torch.sub, logits)
    losses = torch.square(pairwise_logit_diff - pairwise_label_diff)

    list_size = labels.shape[1]
    valid_pair = _pairwise(torch.logical_and, mask.to(torch.bool))
    pairwise_weights = valid_pair.to(torch.float32) * (
        1.0 - torch.eye(list_size, dtype=torch.float32, device=labels.device))
    if self.lambda_weight is not None:
      ranks = sorting.compute_ranks(logits, mask, generator=generator)
      pairwise_weights = pairwise_weights * self.lambda_weight.pair_weights(
          labels, ranks)
    return losses, pairwise_weights.detach()


@dataclasses.dataclass(frozen=True)
class _ListwiseLoss(RankingLoss):
  """Listwise family: one loss value per list."""

  def normalize_weights(self, labels, weights):
    # Label-weighted mean of the item weights per list.
    if weights is None:
      return 1.0
    labels = torch.where(list_ops.is_label_valid(labels), labels, 0.0)
    label_sum = torch.sum(labels, dim=1, keepdim=True)
    weighted = torch.sum(weights * labels, dim=1, keepdim=True)
    return torch.where(label_sum > 0,
                       weighted / torch.clamp(label_sum, min=1e-38), 0.0)

  def per_list(self, labels, logits, weights=None, mask=None, generator=None):
    logits = self.get_logits(_float(logits))
    labels = _float(labels, logits)
    losses, loss_weights = self.unreduced(labels, logits, mask=mask,
                                          generator=generator)
    weights = self.normalize_weights(labels, weights) * loss_weights
    return (torch.squeeze(losses, dim=1),
            torch.squeeze(torch.broadcast_to(weights, losses.shape), dim=1))


@dataclasses.dataclass(frozen=True)
class SoftmaxLoss(_ListwiseLoss):
  """ListNet softmax CE over the label distribution, per-list weighted by
  the label sum (losses_impl.py:1119-1197). A ``DCGLambdaWeight`` folds
  DCG gains and discounts into the labels, item weights fold in after."""

  def precompute(self, labels, logits, weights, mask=None, generator=None):
    """Folds lambda weights and item weights into the labels and masks
    both."""
    if mask is None:
      mask = list_ops.is_label_valid(labels)
    labels = torch.where(mask, labels, 0.0)
    logits = torch.where(mask, logits, LOG_EPSILON)
    if isinstance(self.lambda_weight, lw.DCGLambdaWeight):
      ranks = sorting.compute_ranks(logits, mask, generator=generator)
      labels = self.lambda_weight.individual_weights(labels, ranks)
    if weights is not None:
      labels = labels * weights
    return labels, logits

  def unreduced(self, labels, logits, mask=None, generator=None):
    label_dist, label_sum = _label_distribution(labels, mask)
    losses = softmax_cross_entropy(label_dist, logits)
    return losses, torch.reshape(label_sum, (-1,))

  def _prepared(self, labels, logits, weights, mask, generator):
    logits = self.get_logits(_float(logits))
    labels = _float(labels, logits)
    if mask is None:
      mask = list_ops.is_label_valid(labels)
    labels, logits = self.precompute(labels, logits, weights, mask,
                                     generator=generator)
    return labels, logits, mask

  def __call__(self, labels, logits, weights=None, mask=None,
               reduction: Reduction = Reduction.SUM_BY_NONZERO_WEIGHTS,
               generator: Optional[torch.Generator] = None) -> Tensor:
    labels, logits, mask = self._prepared(labels, logits, weights, mask,
                                          generator)
    losses, softmax_weights = self.unreduced(labels, logits, mask=mask)
    return reduce_weighted(losses, softmax_weights, reduction)

  def per_list(self, labels, logits, weights=None, mask=None, generator=None):
    labels, logits, mask = self._prepared(labels, logits, weights, mask,
                                          generator)
    return self.unreduced(labels, logits, mask=mask)
