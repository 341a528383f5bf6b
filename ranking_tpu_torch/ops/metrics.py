"""Ranking metrics as per-list functions on tensors.

The port's copy of ``ranking_tpu/ops/metrics.py`` (the reference's
tensorflow_ranking/python/metrics_impl.py): the thirteen metrics of the
reference's suite. Every metric
is a frozen dataclass whose ``__call__`` returns ``(per_list_values [B, 1],
per_list_weights [B, 1])``; ``metric_registry.MeanState`` streams their
weighted mean.

Shared semantics: the input preparation (mask = valid label AND weight > 0;
invalid predictions reset below the per-list minimum) and
``per_example_weights_to_per_list_weights`` with its batch-average
fallback for lists with zero relevance.

Every sort goes through ``list_ops.sort_by_scores``, so inside a
``shared_sort_scope`` the suite shares its sort orders, and its 2-D float
channels take the CUDA sort kernel on the card. The diversity metrics'
``[B, L, subtopic]`` labels and the integer or boolean channels take the
plain path, as the JAX package's dispatch rule sends them.
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
class HitsMetric(RankingMetric):
  """Hits@k: 1 if any relevant item is in the top k (metrics_impl.py:462)."""

  def compute(self, labels, predictions, weights, mask):
    sorted_labels, = list_ops.sort_by_scores(
        predictions, [labels], topn=self.topn, mask=mask)
    hits = torch.amax(_binary_relevance(sorted_labels), dim=1, keepdim=True)
    per_list_weights = per_example_weights_to_per_list_weights(
        weights, _binary_relevance(labels))
    return hits, per_list_weights


@dataclasses.dataclass(frozen=True)
class ARPMetric(RankingMetric):
  """Average relevance position (metrics_impl.py:509-536)."""

  def __post_init__(self):
    if self.topn is not None:
      # The reference never exposes a cutoff on ARP; accepting one and
      # ignoring it would be a silent no-op parameter.
      raise ValueError('ARP has no topn cutoff (full-list metric)')

  def compute(self, labels, predictions, weights, mask):
    list_size = predictions.shape[1]
    sorted_labels, sorted_weights = list_ops.sort_by_scores(
        predictions, [labels, weights], topn=list_size, mask=mask)
    weighted_labels = sorted_labels * sorted_weights
    position = torch.arange(1, list_size + 1, dtype=torch.float32,
                            device=labels.device)[None, :]
    per_list_weights = torch.sum(weighted_labels, dim=1, keepdim=True)
    per_list_arp = _div_no_nan(
        torch.sum(position * weighted_labels, dim=1, keepdim=True),
        per_list_weights)
    return per_list_arp, per_list_weights


@dataclasses.dataclass(frozen=True)
class RecallMetric(RankingMetric):
  """Recall@k (metrics_impl.py:539-561, helper :154-177)."""

  def compute(self, labels, predictions, weights, mask):
    sorted_labels, = list_ops.sort_by_scores(
        predictions, [labels], topn=self.topn, mask=mask)
    topn_positives = _binary_relevance(sorted_labels)
    relevance = _binary_relevance(labels)
    per_list_recall = _div_no_nan(
        torch.sum(topn_positives, dim=1, keepdim=True),
        torch.sum(relevance, dim=1, keepdim=True))
    per_list_weights = per_example_weights_to_per_list_weights(
        weights, relevance)
    return per_list_recall, per_list_weights


def _valid_topn(topn: Optional[int], mask: Tensor) -> Tensor:
  """min(topn, valid items) per list, ``[B, 1]`` float32; topn None is the
  list size."""
  topn = mask.shape[1] if topn is None else topn
  return torch.clamp(torch.sum(mask.to(torch.int32), dim=1, keepdim=True),
                     max=topn).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class PrecisionMetric(RankingMetric):
  """Precision@k with valid-topn clamping (metrics_impl.py:564-586)."""

  def compute(self, labels, predictions, weights, mask):
    sorted_labels, = list_ops.sort_by_scores(
        predictions, [labels], topn=self.topn, mask=mask)
    relevance_topn = _binary_relevance(sorted_labels)
    per_list_precision = _div_no_nan(
        torch.sum(relevance_topn, dim=1, keepdim=True),
        _valid_topn(self.topn, mask))
    per_list_weights = per_example_weights_to_per_list_weights(
        weights, _binary_relevance(labels))
    return per_list_precision, per_list_weights


@dataclasses.dataclass(frozen=True)
class MeanAveragePrecisionMetric(RankingMetric):
  """MAP@k (metrics_impl.py:589-628)."""

  def compute(self, labels, predictions, weights, mask):
    relevance = _binary_relevance(labels)
    sorted_relevance, sorted_weights = list_ops.sort_by_scores(
        predictions, [relevance, weights], topn=self.topn, mask=mask)
    relevant_counts = torch.cumsum(sorted_relevance, dim=1)
    cutoffs = torch.cumsum(torch.ones_like(sorted_relevance), dim=1)
    precisions = _div_no_nan(relevant_counts, cutoffs)
    total_precision = torch.sum(
        precisions * sorted_weights * sorted_relevance, dim=1, keepdim=True)
    total_relevance = torch.sum(weights * relevance, dim=1, keepdim=True)
    per_list_map = _div_no_nan(total_precision, total_relevance)
    per_list_weights = per_example_weights_to_per_list_weights(
        weights, relevance)
    return per_list_map, per_list_weights


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


@dataclasses.dataclass(frozen=True)
class DCGMetric(RankingMetric):
  """DCG@k normalized by the per-list weight (metrics_impl.py:673-705)."""

  gain_fn: Callable[[Tensor], Tensor] = DEFAULT_GAIN_FN
  rank_discount_fn: Callable[[Tensor], Tensor] = DEFAULT_RANK_DISCOUNT_FN

  def compute(self, labels, predictions, weights, mask):
    sorted_labels, sorted_weights = list_ops.sort_by_scores(
        predictions, [labels, weights], topn=self.topn, mask=mask)
    dcg = discounted_cumulative_gain(
        sorted_labels, sorted_weights, self.gain_fn, self.rank_discount_fn)
    per_list_weights = per_example_weights_to_per_list_weights(
        weights, self.gain_fn(labels))
    return _div_no_nan(dcg, per_list_weights), per_list_weights


@dataclasses.dataclass(frozen=True)
class OPAMetric(RankingMetric):
  """Ordered pair accuracy (metrics_impl.py:708-743): no sort, ``[B, L, L]``
  pairs."""

  def __post_init__(self):
    if self.topn is not None:
      raise ValueError('OPA has no topn cutoff (all-pairs metric)')

  def compute(self, labels, predictions, weights, mask):
    valid_pair = mask[:, :, None] & mask[:, None, :]
    pair_label_diff = labels[:, :, None] - labels[:, None, :]
    pair_pred_diff = predictions[:, :, None] - predictions[:, None, :]
    correct = ((pair_label_diff > 0).to(torch.float32)
               * (pair_pred_diff > 0).to(torch.float32))
    pair_weights = ((pair_label_diff > 0).to(torch.float32)
                    * weights[:, :, None]
                    * valid_pair.to(torch.float32))
    per_list_weights = torch.sum(pair_weights, dim=(1, 2))[:, None]
    per_list_opa = _div_no_nan(
        torch.sum(correct * pair_weights, dim=(1, 2))[:, None],
        per_list_weights)
    return per_list_opa, per_list_weights


@dataclasses.dataclass(frozen=True)
class _DivRankingMetric(RankingMetric):
  """Diversity metrics over ``[B, L, subtopic]`` labels
  (metrics_impl.py:313)."""

  def prepare(self, labels, predictions, weights, mask):
    labels = torch.as_tensor(labels, dtype=torch.float32)
    predictions = torch.as_tensor(predictions, dtype=torch.float32)
    if labels.ndim != 3:
      raise ValueError(
          f'Diversity labels must be rank 3, got {tuple(labels.shape)}')
    if mask is None:
      mask = list_ops.is_label_valid(labels)
    if mask.ndim == 3:
      mask = torch.any(mask, dim=2)
    predictions = torch.where(
        mask, predictions,
        -1e-6 + torch.amin(predictions, dim=1, keepdim=True))
    labels = torch.where(mask[:, :, None], labels, 0.0)
    weights = (1.0 if weights is None
               else torch.as_tensor(weights, dtype=torch.float32))
    example_weights = torch.ones_like(predictions) * weights
    return labels, predictions, example_weights, mask

  def _per_list_weights(self, weights, labels):
    return per_example_weights_to_per_list_weights(
        weights, torch.any(labels >= 1.0, dim=-1).to(torch.float32))


@dataclasses.dataclass(frozen=True)
class PrecisionIAMetric(_DivRankingMetric):
  """Intent-aware Precision@k (metrics_impl.py:746-782)."""

  def compute(self, labels, predictions, weights, mask):
    sorted_labels, = list_ops.sort_by_scores(
        predictions, [labels], topn=self.topn, mask=mask)
    relevance = torch.sum((sorted_labels >= 1.0).to(torch.float32), dim=-1)
    num_subtopics = torch.sum(
        torch.any(labels >= 1.0, dim=1, keepdim=True).to(torch.float32),
        dim=-1)
    per_list = _div_no_nan(
        torch.sum(relevance, dim=1, keepdim=True),
        torch.sum(_valid_topn(self.topn, mask) * num_subtopics,
                  dim=1, keepdim=True))
    return per_list, self._per_list_weights(weights, labels)


@dataclasses.dataclass(frozen=True)
class AlphaDCGMetric(_DivRankingMetric):
  """alpha-DCG@k for diversification (metrics_impl.py:785-822)."""

  alpha: float = 0.5
  rank_discount_fn: Callable[[Tensor], Tensor] = DEFAULT_RANK_DISCOUNT_FN

  def _gain_fn(self, labels: Tensor) -> Tensor:
    # Subtopic gains decay by (1 - alpha)^(#docs already covering it).
    cum_subtopics = torch.cumsum(labels, dim=1) - labels  # exclusive cumsum
    return torch.sum(
        labels * torch.pow(1.0 - self.alpha, cum_subtopics), dim=-1)

  def compute(self, labels, predictions, weights, mask):
    sorted_labels, sorted_weights = list_ops.sort_by_scores(
        predictions, [labels, weights], topn=self.topn, mask=mask)
    alpha_dcg = discounted_cumulative_gain(
        sorted_labels, sorted_weights, self._gain_fn, self.rank_discount_fn)
    per_list_weights = self._per_list_weights(weights, labels)
    return _div_no_nan(alpha_dcg, per_list_weights), per_list_weights


@dataclasses.dataclass(frozen=True)
class BPrefMetric(RankingMetric):
  """Binary preference; TREC-2005 or classic formula (metrics_impl.py:825)."""

  use_trec_version: bool = True

  def compute(self, labels, predictions, weights, mask):
    relevance = _binary_relevance(labels)
    irrelevance = mask.to(torch.float32) - relevance
    total_relevance = torch.sum(relevance, dim=1, keepdim=True)
    total_irrelevance = torch.sum(irrelevance, dim=1, keepdim=True)
    sorted_relevance, sorted_irrelevance = list_ops.sort_by_scores(
        predictions, [relevance, irrelevance], topn=self.topn, mask=mask)
    numerator = torch.minimum(
        torch.cumsum(sorted_irrelevance, dim=1), total_relevance)
    denominator = (torch.minimum(total_irrelevance, total_relevance)
                   if self.use_trec_version else total_relevance)
    bpref = _div_no_nan(
        torch.sum((1.0 - _div_no_nan(numerator, denominator))
                  * sorted_relevance, dim=1, keepdim=True),
        total_relevance)
    per_list_weights = per_example_weights_to_per_list_weights(
        weights, relevance)
    return bpref, per_list_weights


@dataclasses.dataclass(frozen=True)
class PWAMetric(RankingMetric):
  """Position-weighted average rating; weights must be per-list [B, 1]
  (metrics_impl.py:901-965)."""

  topn: Optional[int] = 5

  def compute(self, labels, predictions, weights, mask):
    sorted_labels, sorted_mask = list_ops.sort_by_scores(
        predictions, [labels, mask], topn=self.topn, mask=mask)
    position_weights = 1.0 / torch.arange(
        1, sorted_labels.shape[1] + 1, dtype=torch.float32,
        device=labels.device)
    masked_pw = sorted_mask.to(torch.float32) * position_weights[None, :]
    pwa = _div_no_nan(
        torch.sum(sorted_labels * masked_pw, dim=1, keepdim=True),
        torch.sum(masked_pw, dim=1, keepdim=True))
    return pwa, weights[:, :1]

  def __call__(self, labels, predictions, weights=None, mask=None):
    # The reference raises unless PWA weights are per-list [batch_size, 1]
    # (metrics_impl.py:901-965): averaging per-example weights would
    # diverge without a diagnostic. Checked before prepare broadcasts them.
    if weights is not None:
      shape = tuple(torch.as_tensor(weights).shape)
      if len(shape) >= 2 and shape[-1] != 1:
        raise ValueError(
            f'PWA weights must be per-list [batch_size, 1] (got shape '
            f'{shape})')
    return super().__call__(labels, predictions, weights=weights, mask=mask)
