"""Ranking losses as pure, masking-aware functions on tensors.

The port's copy of the softmax part of ``ranking_tpu/ops/losses.py`` (the
reference's tensorflow_ranking/python/losses_impl.py). Losses are frozen
dataclasses with pure methods:

* ``unreduced(labels, logits, mask) -> (losses, loss_weights)``
* ``normalize_weights(labels, weights)``: the family's weight semantics
* ``__call__(labels, logits, weights, mask, reduction) -> scalar``
* ``per_list(...) -> ([B] losses, [B] weights)`` for loss-as-metric streams

``labels`` and ``logits`` are ``[B, L]`` float32, the padding label is -1
and ``mask = labels >= 0`` when not given. Ported so far: ``SoftmaxLoss``
without lambda weights; the other losses of the zoo raise "not ported yet"
in ``ops/loss_registry.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from ranking_tpu_torch.ops.reductions import Reduction, reduce_weighted
from ranking_tpu_torch.utils import list_ops

Tensor = torch.Tensor

EPSILON = 1e-10
LOG_EPSILON = math.log(EPSILON)


def _float(x, like: Optional[Tensor] = None) -> Tensor:
  device = None if like is None else like.device
  return torch.as_tensor(x, device=device).to(torch.float32)


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
  lambda_weight: Optional[Any] = None
  temperature: float = 1.0

  def unreduced(self, labels, logits, mask=None):
    raise NotImplementedError

  def normalize_weights(self, labels: Tensor, weights):
    del labels
    return 1.0 if weights is None else weights

  def get_logits(self, logits: Tensor) -> Tensor:
    return logits / self.temperature

  def __call__(self, labels, logits, weights=None, mask=None,
               reduction: Reduction = Reduction.SUM_BY_NONZERO_WEIGHTS
               ) -> Tensor:
    """Reduced scalar loss (losses_impl.py:787-814)."""
    logits = self.get_logits(_float(logits))
    labels = _float(labels, logits)
    losses, loss_weights = self.unreduced(labels, logits, mask=mask)
    weights = self.normalize_weights(labels, weights) * loss_weights
    return reduce_weighted(losses, weights, reduction)

  def per_list(self, labels, logits, weights=None, mask=None):
    raise NotImplementedError


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

  def per_list(self, labels, logits, weights=None, mask=None):
    logits = self.get_logits(_float(logits))
    labels = _float(labels, logits)
    losses, loss_weights = self.unreduced(labels, logits, mask=mask)
    weights = self.normalize_weights(labels, weights) * loss_weights
    return (torch.squeeze(losses, dim=1),
            torch.squeeze(torch.broadcast_to(weights, losses.shape), dim=1))


@dataclasses.dataclass(frozen=True)
class SoftmaxLoss(_ListwiseLoss):
  """ListNet softmax CE over the label distribution, per-list weighted by
  the label sum (losses_impl.py:1119-1197). Item weights fold into the
  labels. The DCG lambda-weight branch is not ported yet."""

  def __post_init__(self):
    if self.lambda_weight is not None:
      raise NotImplementedError(
          'SoftmaxLoss with a lambda weight is not ported yet: the PyTorch '
          'port has no ops/lambda_weights.py')

  def precompute(self, labels, logits, weights, mask=None):
    """Folds the item weights into the labels and masks both."""
    if mask is None:
      mask = list_ops.is_label_valid(labels)
    labels = torch.where(mask, labels, 0.0)
    logits = torch.where(mask, logits, LOG_EPSILON)
    if weights is not None:
      labels = labels * weights
    return labels, logits

  def unreduced(self, labels, logits, mask=None):
    label_dist, label_sum = _label_distribution(labels, mask)
    losses = softmax_cross_entropy(label_dist, logits)
    return losses, torch.reshape(label_sum, (-1,))

  def _prepared(self, labels, logits, weights, mask):
    logits = self.get_logits(_float(logits))
    labels = _float(labels, logits)
    if mask is None:
      mask = list_ops.is_label_valid(labels)
    labels, logits = self.precompute(labels, logits, weights, mask)
    return labels, logits, mask

  def __call__(self, labels, logits, weights=None, mask=None,
               reduction: Reduction = Reduction.SUM_BY_NONZERO_WEIGHTS
               ) -> Tensor:
    labels, logits, mask = self._prepared(labels, logits, weights, mask)
    losses, softmax_weights = self.unreduced(labels, logits, mask=mask)
    return reduce_weighted(losses, softmax_weights, reduction)

  def per_list(self, labels, logits, weights=None, mask=None):
    labels, logits, mask = self._prepared(labels, logits, weights, mask)
    return self.unreduced(labels, logits, mask=mask)
