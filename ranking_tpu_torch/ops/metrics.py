"""Ranking metrics as per-list functions on tensors.

The port's copy of the NDCG and MRR parts of ``ranking_tpu/ops/metrics.py``
(the reference's tensorflow_ranking/python/metrics_impl.py). Every metric
is a frozen dataclass whose ``__call__`` returns ``(per_list_values [B, 1],
per_list_weights [B, 1])``; ``metric_registry.MeanState`` streams their
weighted mean.

Shared semantics: the input preparation (mask = valid label AND weight > 0;
invalid predictions reset below the per-list minimum) and
``per_example_weights_to_per_list_weights`` with its batch-average
fallback for lists with zero relevance.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ranking_tpu_torch.utils import fns, list_ops

Tensor = torch.Tensor

DEFAULT_GAIN_FN = fns.pow_minus_1
DEFAULT_RANK_DISCOUNT_FN = fns.log2_inverse


def _div_no_nan(a: Tensor, b: Tensor) -> Tensor:
  nonzero = b != 0
  return torch.where(nonzero, a / torch.where(nonzero, b, 1.0), 0.0)


def per_example_weights_to_per_list_weights(
    weights: Tensor, relevance: Tensor) -> Tensor:
  """Per-list weights = sum(weights * relevance) / sum(relevance).

  Lists with zero total relevance (but nonzero weight) fall back to the
  batch-average per-list weight; if every list has zero relevance the
  average is 1.0 (metrics_impl.py:63-119).
  """
  nonzero_weights = torch.sum(weights, dim=1, keepdim=True) > 0.0
  per_list_relevance = torch.sum(relevance, dim=1, keepdim=True)
  nonzero_relevance = torch.where(
      nonzero_weights, (per_list_relevance > 0.0).to(torch.float32), 0.0)
  nonzero_relevance_count = torch.sum(nonzero_relevance, dim=0, keepdim=True)

  per_list_weights = _div_no_nan(
      torch.sum(weights * relevance, dim=1, keepdim=True),
      per_list_relevance)
  sum_weights = torch.sum(per_list_weights, dim=0, keepdim=True)
  avg_weight = torch.where(
      nonzero_relevance_count > 0.0,
      _div_no_nan(sum_weights, nonzero_relevance_count),
      torch.ones_like(nonzero_relevance_count))
  return torch.where(
      nonzero_weights,
      torch.where(per_list_relevance > 0.0, per_list_weights, avg_weight),
      0.0)


def discounted_cumulative_gain(
    labels: Tensor,
    weights: Tensor,
    gain_fn: Callable[[Tensor], Tensor] = DEFAULT_GAIN_FN,
    rank_discount_fn: Callable[[Tensor], Tensor] = DEFAULT_RANK_DISCOUNT_FN,
) -> Tensor:
  """Weighted DCG over already rank-ordered labels; [B, 1]."""
  list_size = labels.shape[1]
  position = torch.arange(1, list_size + 1, dtype=torch.float32,
                          device=labels.device)
  gain = gain_fn(labels.to(torch.float32))
  discount = rank_discount_fn(position)
  return torch.sum(weights * gain * discount, dim=1, keepdim=True)


@dataclasses.dataclass(frozen=True)
class RankingMetric:
  """Base metric: shared input preparation + compute dispatch."""

  name: str = ''
  topn: Optional[int] = None

  def prepare(self, labels, predictions, weights, mask):
    # Inside a shared_sort_scope (the eval step), identical preparations
    # are interned: every metric of the suite then holds the SAME prepared
    # tensors, so their sorts collapse into the scope's one sort order.
    # prepare does not depend on the metric, so the interning is exact.
    cache = list_ops.shared_sort_cache()
    ck = None
    if cache is not None:
      ck = ('metric_prepare', id(labels), id(predictions), id(weights),
            id(mask))
      hit = cache.get(ck)
      if hit is not None:
        # The stored inputs tuple keeps the keyed objects alive so their
        # ids cannot be recycled; check the invariant on every hit.
        pinned = hit[0]
        if not (pinned[0] is labels and pinned[1] is predictions
                and pinned[2] is weights and pinned[3] is mask):
          raise AssertionError(
              'shared_sort_scope id-cache hit with non-identical '
              'operands: id() was recycled; the pinned inputs tuple '
              'must keep keyed objects alive')
        return hit[1]
      inputs = (labels, predictions, weights, mask)  # pin ids
    labels = torch.as_tensor(labels, dtype=torch.float32)
    predictions = torch.as_tensor(predictions, dtype=torch.float32)
    weights = (1.0 if weights is None
               else torch.as_tensor(weights, dtype=torch.float32))
    example_weights = torch.ones_like(labels) * weights
    if mask is None:
      mask = list_ops.is_label_valid(labels)
    mask = mask & (example_weights > 0.0)
    labels = torch.where(mask, labels, 0.0)
    predictions = torch.where(
        mask, predictions,
        -1e-6 + torch.amin(predictions, dim=1, keepdim=True))
    out = (labels, predictions, example_weights, mask)
    if ck is not None:
      cache[ck] = (inputs, out)
    return out

  def __call__(self, labels, predictions, weights=None,
               mask=None) -> Tuple[Tensor, Tensor]:
    labels, predictions, weights, mask = self.prepare(
        labels, predictions, weights, mask)
    return self.compute(labels, predictions, weights, mask)

  def compute(self, labels, predictions, weights, mask):
    raise NotImplementedError


def _binary_relevance(labels: Tensor) -> Tensor:
  return (labels >= 1.0).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class MRRMetric(RankingMetric):
  """Mean reciprocal rank over topn (metrics_impl.py:429-459)."""

  def compute(self, labels, predictions, weights, mask):
    sorted_labels, = list_ops.sort_by_scores(
        predictions, [labels], topn=self.topn, mask=mask)
    relevance = _binary_relevance(sorted_labels)
    rr = 1.0 / torch.arange(1, sorted_labels.shape[1] + 1,
                            dtype=torch.float32, device=labels.device)
    mrr = torch.amax(relevance * rr[None, :], dim=1, keepdim=True)
    per_list_weights = per_example_weights_to_per_list_weights(
        weights, _binary_relevance(labels))
    return mrr, per_list_weights


@dataclasses.dataclass(frozen=True)
class NDCGMetric(RankingMetric):
  """NDCG@k with configurable gain/discount (metrics_impl.py:631-670)."""

  gain_fn: Callable[[Tensor], Tensor] = DEFAULT_GAIN_FN
  rank_discount_fn: Callable[[Tensor], Tensor] = DEFAULT_RANK_DISCOUNT_FN

  def compute(self, labels, predictions, weights, mask):
    sorted_labels, sorted_weights = list_ops.sort_by_scores(
        predictions, [labels, weights], topn=self.topn, mask=mask)
    dcg = discounted_cumulative_gain(
        sorted_labels, sorted_weights, self.gain_fn, self.rank_discount_fn)
    weighted_gains = weights * self.gain_fn(labels)
    ideal_labels, ideal_weights = list_ops.sort_by_scores(
        weighted_gains, [labels, weights], topn=self.topn, mask=mask)
    ideal_dcg = discounted_cumulative_gain(
        ideal_labels, ideal_weights, self.gain_fn, self.rank_discount_fn)
    per_list_ndcg = _div_no_nan(dcg, ideal_dcg)
    per_list_weights = per_example_weights_to_per_list_weights(
        weights, self.gain_fn(labels))
    return per_list_ndcg, per_list_weights
