"""LambdaWeight framework: metric-driven pair and item weights for losses.

The port's copy of ``ranking_tpu/ops/lambda_weights.py`` (the reference's
tensorflow_ranking/python/losses_impl.py:170-480). Each LambdaWeight is a
frozen dataclass exposing two pure functions:

* ``pair_weights(labels, ranks) -> [B, L, L]`` for pairwise losses,
* ``individual_weights(labels, ranks) -> [B, L]`` for listwise losses.

Ranks are 1-based and typically come from ``ops.sorting.compute_ranks``.
The factories build their weights from the named functions of
``utils/fns.py``, because the fused pairwise dispatcher
(``ops/cuda/pairwise.py``) recognizes a discount by identity.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ranking_tpu_torch.utils import fns, list_ops

Tensor = torch.Tensor
ScalarFn = Callable[[Tensor], Tensor]


def _pairwise(op, t: Tensor) -> Tensor:
  """Applies a binary op on all in-list pairs: out[b, i, j] = op(t_i, t_j)."""
  return op(t[:, :, None], t[:, None, :])


def _valid_pairs_and_clean_labels(labels: Tensor):
  is_valid = list_ops.is_label_valid(labels)
  valid_pair = _pairwise(torch.logical_and, is_valid)
  return valid_pair, torch.where(is_valid, labels, 0.0)


class LambdaWeight:
  """Interface: see the module docstring."""

  def pair_weights(self, labels: Tensor, ranks: Tensor) -> Tensor:
    raise NotImplementedError

  def individual_weights(self, labels: Tensor, ranks: Tensor) -> Tensor:
    del ranks
    return labels


@dataclasses.dataclass(frozen=True)
class LabelDiffLambdaWeight(LambdaWeight):
  """Absolute label difference per pair."""

  def pair_weights(self, labels: Tensor, ranks: Tensor) -> Tensor:
    del ranks
    return torch.abs(_pairwise(torch.sub, labels))


@dataclasses.dataclass(frozen=True)
class AbstractDCGLambdaWeight(LambdaWeight):
  """Shared DCG lambda-weight math; subclasses define the pair rank
  discount (losses_impl.py:219-296). Note the deliberate ``* list_size``
  rescale on pair weights: a heuristic keeping LambdaLoss magnitudes
  comparable to plain pairwise losses.
  """

  topn: Optional[int] = None
  gain_fn: ScalarFn = fns.identity
  rank_discount_fn: ScalarFn = fns.inverse
  normalized: bool = False

  def _pair_rank_discount(self, ranks: Tensor, topn: int) -> Tensor:
    raise NotImplementedError

  def _gains(self, labels: Tensor) -> Tensor:
    gain = self.gain_fn(labels)
    if self.normalized:
      gain = gain * _inverse_max_dcg_like(
          labels, self.gain_fn, self.rank_discount_fn, self.topn)
    return gain

  def pair_weights(self, labels: Tensor, ranks: Tensor) -> Tensor:
    valid_pair, labels = _valid_pairs_and_clean_labels(labels)
    gain = self._gains(labels)
    pair_gain = _pairwise(torch.sub, gain) * valid_pair.to(torch.float32)
    list_size = labels.shape[1]
    topn = self.topn or list_size
    pair_weight = torch.abs(pair_gain) * self._pair_rank_discount(ranks, topn)
    return pair_weight * float(list_size)

  def individual_weights(self, labels: Tensor, ranks: Tensor) -> Tensor:
    labels = torch.where(list_ops.is_label_valid(labels), labels, 0.0)
    gain = self._gains(labels)
    return gain * self.rank_discount_fn(ranks.to(torch.float32))


def _inverse_max_dcg_like(labels, gain_fn, rank_discount_fn, topn):
  # Local import: ops.sorting is a sibling that the losses import too.
  from ranking_tpu_torch.ops import sorting
  return sorting.inverse_max_dcg(
      labels, gain_fn=gain_fn, rank_discount_fn=rank_discount_fn, topn=topn)


def _adjacent_discount_gap(rank_discount_fn: ScalarFn,
                           rank_diff: Tensor) -> Tensor:
  """``|D(k) - D(k + 1)|`` for rank distance k (LambdaLoss Eq. 18); the
  caller selects it away where k == 0."""
  return torch.abs(rank_discount_fn(torch.clamp(rank_diff, min=1e-12))
                   - rank_discount_fn(rank_diff + 1.0))


@dataclasses.dataclass(frozen=True)
class DCGLambdaWeight(AbstractDCGLambdaWeight):
  """LambdaLoss/LambdaMART mixed pair discount.

  u = |D(|i-j|) - D(|i-j|+1)| (LambdaLoss Eq.18), v = |D(i) - D(j)|
  (LambdaMART); combined as (1 - smooth_fraction) * u + smooth_fraction * v,
  masked to pairs with min(rank_i, rank_j) <= topn (losses_impl.py:299-369).
  """

  smooth_fraction: float = 0.0

  def __post_init__(self):
    if not 0.0 <= self.smooth_fraction <= 1.0:
      raise ValueError(
          f'smooth_fraction must be in [0, 1], got {self.smooth_fraction}')

  def _pair_rank_discount(self, ranks: Tensor, topn: int) -> Tensor:
    ranks_f = ranks.to(torch.float32)
    pair_valid_rank = _pairwise(torch.logical_or, ranks <= topn)
    rank_diff = torch.abs(_pairwise(torch.sub, ranks_f))
    u = torch.where(
        (rank_diff > 0) & pair_valid_rank,
        _adjacent_discount_gap(self.rank_discount_fn, rank_diff), 0.0)
    capped = torch.where(ranks > topn, 0.0, self.rank_discount_fn(ranks_f))
    v = torch.abs(_pairwise(torch.sub, capped))
    pair_discount = (1.0 - self.smooth_fraction) * u + self.smooth_fraction * v
    return pair_discount * pair_valid_rank.to(torch.float32)


@dataclasses.dataclass(frozen=True)
class DCGLambdaWeightV2(AbstractDCGLambdaWeight):
  """LambdaLoss discount with the improved topn handling.

  Pairs whose max rank exceeds topn are scaled by 1 / (1 - D(max_rank))
  instead of being hard-masked (losses_impl.py:372).
  """

  def _pair_rank_discount(self, ranks: Tensor, topn: int) -> Tensor:
    ranks_f = ranks.to(torch.float32)
    rank_diff = torch.abs(_pairwise(torch.sub, ranks_f))
    max_rank = _pairwise(torch.maximum, ranks_f)
    multiplier = torch.where(
        max_rank > float(topn),
        1.0 / (1.0 - self.rank_discount_fn(max_rank)), 1.0)
    return torch.where(
        rank_diff > 0.0,
        _adjacent_discount_gap(self.rank_discount_fn, rank_diff) * multiplier,
        0.0)


@dataclasses.dataclass(frozen=True)
class YetiDCGLambdaWeight(DCGLambdaWeightV2):
  """V2 restricted to neighbor pairs (|rank_i - rank_j| == 1)
  (losses_impl.py:397-407)."""

  def pair_weights(self, labels: Tensor, ranks: Tensor) -> Tensor:
    pair_weight = super().pair_weights(labels, ranks)
    neighbor = torch.abs(_pairwise(torch.sub, ranks)) == 1
    return pair_weight * neighbor.to(torch.float32)


def _label_at_least_1(label: Tensor) -> Tensor:
  return label >= 1.0


@dataclasses.dataclass(frozen=True)
class PrecisionLambdaWeight(LambdaWeight):
  """Swap gain for Precision@k: binary label diff x xor(i<=k, j<=k)
  (losses_impl.py:410-454)."""

  topn: int = 10
  positive_fn: ScalarFn = _label_at_least_1

  def pair_weights(self, labels: Tensor, ranks: Tensor) -> Tensor:
    valid_pair, labels = _valid_pairs_and_clean_labels(labels)
    binary = self.positive_fn(labels).to(torch.float32)
    label_diff = torch.abs(_pairwise(torch.sub, binary))
    label_diff = label_diff * valid_pair.to(torch.float32)
    rank_mask = _pairwise(torch.logical_xor, ranks <= self.topn)
    return label_diff * rank_mask.to(torch.float32)


def _constant_one(rank: Tensor) -> Tensor:
  return torch.ones_like(rank)


@dataclasses.dataclass(frozen=True)
class ListMLELambdaWeight(LambdaWeight):
  """Position-aware ListMLE discounts over rank positions
  (losses_impl.py:457-480)."""

  rank_discount_fn: ScalarFn = _constant_one

  def pair_weights(self, labels: Tensor, ranks: Tensor) -> Tensor:
    raise NotImplementedError('ListMLELambdaWeight has no pair weights.')

  def individual_weights(self, labels: Tensor, ranks: Tensor) -> Tensor:
    return torch.ones_like(labels) * self.rank_discount_fn(
        ranks.to(torch.float32))


def create_ndcg_lambda_weight(
    topn: Optional[int] = None,
    smooth_fraction: float = 0.0,
) -> DCGLambdaWeight:
  """NDCG LambdaWeight: gain 2^l - 1, discount 1/log1p(rank), normalized."""
  return DCGLambdaWeight(
      topn=topn,
      gain_fn=fns.pow_minus_1,
      rank_discount_fn=fns.log1p_inverse,
      normalized=True,
      smooth_fraction=smooth_fraction)


def create_ndcg_lambda_weight_v2(
    topn: Optional[int] = None) -> DCGLambdaWeightV2:
  """V2 NDCG LambdaWeight (better topn handling)."""
  return DCGLambdaWeightV2(
      topn=topn,
      gain_fn=fns.pow_minus_1,
      rank_discount_fn=fns.log1p_inverse,
      normalized=True)


def create_yeti_dcg_lambda_weight(
    topn: Optional[int] = None) -> YetiDCGLambdaWeight:
  """Neighbor-pair DCG LambdaWeight used by the yeti losses.

  Un-normalized, so the discount must be the keras default log(2)/log1p
  (tensorflow_ranking/python/keras/losses.py:184-187): the log(2) factor
  does not cancel here as it does in the normalized NDCG weights.
  """
  return YetiDCGLambdaWeight(
      topn=topn,
      gain_fn=fns.pow_minus_1,
      rank_discount_fn=fns.log2_inverse,
      normalized=False)


def create_reciprocal_rank_lambda_weight(
    topn: Optional[int] = None,
    smooth_fraction: float = 0.0,
) -> DCGLambdaWeight:
  """MRR-like LambdaWeight: identity gain, 1/rank discount, normalized."""
  return DCGLambdaWeight(
      topn=topn,
      gain_fn=fns.identity,
      rank_discount_fn=fns.inverse,
      normalized=True,
      smooth_fraction=smooth_fraction)


def create_p_list_mle_lambda_weight(list_size: int) -> ListMLELambdaWeight:
  """Position-Aware ListMLE weight: 2^(n - rank) - 1 (Lan et al.)."""
  return ListMLELambdaWeight(
      rank_discount_fn=lambda rank: torch.exp2(float(list_size) - rank) - 1.0)
