"""The ranking loss zoo as pure, masking-aware functions on tensors.

The port's copy of ``ranking_tpu/ops/losses.py`` (the reference's
tensorflow_ranking/python/losses_impl.py). Losses are frozen dataclasses
with pure methods:

* ``unreduced(labels, logits, mask, generator) -> (losses, loss_weights)``
* ``normalize_weights(labels, weights)``: the family's weight semantics
  (pointwise item validity, pairwise left-item expansion, listwise
  label-weighted mean)
* ``__call__(labels, logits, weights, mask, reduction, generator, ragged)
  -> scalar``
* ``per_list(...) -> ([B] losses, [B] weights)`` for loss-as-metric streams

``labels`` and ``logits`` are ``[B, L]`` float32 (``[B, L, units]`` logits
for the ordinal, multi-class, click-EM and mixture-EM heads; float64 logits
compute in float64), the padding label is -1 and ``mask = labels >= 0``
when not given. ``generator`` (the
JAX package's ``key``) shuffles rank ties under a lambda weight and the
label ties of ListMLE, and draws the Gumbel samples of
``CoupledRankDistilLoss``. Where the JAX package falls back to the fixed key
37 for ``key=None``, the port takes the kept draws of seed 37
(``sorting.fixed_draws``): every call without a generator draws the same
numbers, which are not JAX's. ``.detach()`` stands where JAX has
``stop_gradient``.

The O(L^2) pairwise tensors formed here are the semantic source of truth,
and the only path on the CPU; on the card the fused kernels of
``ops/cuda/pairwise.py`` compute the pairwise losses' sums without a
``[B, L, L]`` tensor in memory.
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

# The seed of the fixed draws of a call without a generator: the JAX
# package's fallback key for tie shuffles and distillation samples
# (losses.py:48-52; the reference's op-level seed 37, losses_impl.py:1560).
_DEFAULT_SEED = 37


def _float(x, like: Optional[Tensor] = None) -> Tensor:
  """``x`` as float32 on ``like``'s device; float64 stays float64, so that
  the same code gives a float64 recompute of a loss (``chip_smoke.py``)."""
  device = None if like is None else like.device
  x = torch.as_tensor(x, device=device)
  return x if x.dtype == torch.float64 else x.to(torch.float32)


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


def _maximum0(x: Tensor) -> Tensor:
  # torch.maximum splits the gradient of a tie evenly, as jnp.maximum does.
  return torch.maximum(x, torch.zeros_like(x))


def _clip(x: Tensor, lo: float, hi: float) -> Tensor:
  """jnp.clip: a maximum then a minimum, with their tie gradients."""
  return torch.minimum(torch.maximum(x, torch.full_like(x, lo)),
                       torch.full_like(x, hi))


def _softplus(x: Tensor) -> Tensor:
  """jax.nn.softplus, log(1 + e^x) with no linear cut-off."""
  return torch.logaddexp(x, torch.zeros_like(x))


def _abs(x: Tensor) -> Tensor:
  # jnp.abs's derivative at 0 is +1; torch.abs's is 0.
  return torch.where(x >= 0, x, -x)


def sigmoid_cross_entropy(labels: Tensor, logits: Tensor) -> Tensor:
  """Numerically stable elementwise sigmoid CE with soft labels. At a logit
  of exactly 0 its gradient is JAX's, sigmoid(0) - label - 0.5: ``_abs``
  and ``_maximum0`` take jnp.abs's and jnp.maximum's derivatives there."""
  return (_maximum0(logits) - logits * labels
          + torch.log1p(torch.exp(-_abs(logits))))


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
               generator: Optional[torch.Generator] = None,
               ragged: bool = False) -> Tensor:
    """Reduced scalar loss (losses_impl.py:787-814).

    With ``ragged=True``, ``labels``, ``logits`` and ``weights`` are
    variable-length lists of lists on the host, densified with the
    reference's padding values first (``list_ops.ragged_to_dense``,
    losses_impl.py:692-694).
    """
    if ragged:
      labels, logits, weights, mask = list_ops.ragged_to_dense(
          labels, logits, weights)
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
               generator: Optional[torch.Generator] = None,
               ragged: bool = False) -> Tensor:
    if ragged:
      labels, logits, weights, mask = list_ops.ragged_to_dense(
          labels, logits, weights)
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
class CircleLoss(_ListwiseLoss):
  """Circle loss (Sun et al. 2020) on similarity scores clipped to [0, 1]
  (losses_impl.py:1036-1116)."""

  gamma: float = 64.0
  margin: float = 0.25

  def get_logits(self, logits: Tensor) -> Tensor:
    return _clip(logits, 0.0, 1.0)

  def unreduced(self, labels, logits, mask=None, generator=None):
    if mask is None:
      mask = list_ops.is_label_valid(labels)
    score_i = logits[:, :, None]
    score_j = logits[:, None, :]
    alpha_i = _maximum0(1.0 - score_i + self.margin).detach()
    alpha_j = _maximum0(score_j + self.margin).detach()
    pairwise_logits = (alpha_i * (1.0 - score_i - self.margin)
                       + alpha_j * (score_j - self.margin))

    pairwise_label_diff = _pairwise(torch.sub, labels)
    valid_pair = _pairwise(torch.logical_and, mask.to(torch.bool))
    pairwise_labels = ((pairwise_label_diff > 0).to(torch.float32)
                       * valid_pair.to(torch.float32)).detach()

    # log1p(sum_k w_k exp(g x_k)) as softplus(logsumexp(g x + ln w)), so
    # that exp(gamma * x) cannot overflow in the forward or the gradient.
    log_terms = torch.where(
        pairwise_labels > 0.0,
        self.gamma * pairwise_logits
        + torch.log(torch.clamp(pairwise_labels, min=EPSILON)),
        -math.inf)
    flat = log_terms.reshape(log_terms.shape[0], -1)
    has_pairs = torch.any((pairwise_labels > 0.0).reshape(flat.shape), dim=1)
    lse = torch.logsumexp(torch.where(has_pairs[:, None], flat, 0.0), dim=1)
    per_list_losses = torch.where(has_pairs, _softplus(lse), 0.0)
    num_pairs = torch.sum((pairwise_labels > 0).to(torch.float32),
                          dim=(1, 2))
    pair_weight_sum = torch.sum(pairwise_labels, dim=(1, 2))
    per_list_weights = torch.where(
        num_pairs > 0, pair_weight_sum / torch.clamp(num_pairs, min=1.0),
        0.0)
    return per_list_losses[:, None], per_list_weights[:, None]


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
               generator: Optional[torch.Generator] = None,
               ragged: bool = False) -> Tensor:
    if ragged:
      labels, logits, weights, mask = list_ops.ragged_to_dense(
          labels, logits, weights)
    labels, logits, mask = self._prepared(labels, logits, weights, mask,
                                          generator)
    losses, softmax_weights = self.unreduced(labels, logits, mask=mask)
    return reduce_weighted(losses, softmax_weights, reduction)

  def per_list(self, labels, logits, weights=None, mask=None, generator=None):
    labels, logits, mask = self._prepared(labels, logits, weights, mask,
                                          generator)
    return self.unreduced(labels, logits, mask=mask)


@dataclasses.dataclass(frozen=True)
class CalibratedSoftmaxLoss(SoftmaxLoss):
  """Softmax CE with a virtual anchor item per list (Yan et al. 2022).

  A virtual label ``y_0 >= 0`` with a fixed score of 0 is appended to every
  list, which calibrates the scores' absolute scale: loss =
  -sum_i y_i log(exp(s_i) / (1 + sum_j exp(s_j)))
  - y_0 log(1 / (1 + sum_j exp(s_j)))
  (tensorflow_ranking/python/keras/losses.py:836-943). The anchor's score
  is 0 before and after the temperature.
  """

  virtual_label: float = 0.0

  def __post_init__(self):
    if self.virtual_label < 0:
      raise ValueError('virtual_label must be non-negative.')

  def _augment(self, labels, logits, weights, mask):
    batch = labels.shape[0]
    labels = torch.cat([labels, torch.full((batch, 1), self.virtual_label,
                                           dtype=labels.dtype,
                                           device=labels.device)], dim=1)
    logits = torch.cat([logits, torch.zeros((batch, 1), dtype=logits.dtype,
                                            device=logits.device)], dim=1)
    if weights is not None and weights.ndim == 2 and weights.shape[1] > 1:
      weights = torch.cat([weights, torch.ones((batch, 1), dtype=weights.dtype,
                                               device=weights.device)], dim=1)
    if mask is not None:
      mask = torch.cat([mask.to(torch.bool),
                        torch.ones((batch, 1), dtype=torch.bool,
                                   device=mask.device)], dim=1)
    return labels, logits, weights, mask

  def _augmented(self, labels, logits, weights, mask):
    logits = _float(logits)
    labels = _float(labels, logits)
    if mask is None:
      mask = list_ops.is_label_valid(labels)
    if weights is not None:
      weights = _float(weights, logits)
    return self._augment(labels, logits, weights, mask)

  def __call__(self, labels, logits, weights=None, mask=None,
               reduction: Reduction = Reduction.SUM_BY_NONZERO_WEIGHTS,
               generator: Optional[torch.Generator] = None,
               ragged: bool = False) -> Tensor:
    if ragged:
      labels, logits, weights, mask = list_ops.ragged_to_dense(
          labels, logits, weights)
    labels, logits, weights, mask = self._augmented(labels, logits, weights,
                                                    mask)
    return SoftmaxLoss.__call__(self, labels, logits, weights=weights,
                                mask=mask, reduction=reduction,
                                generator=generator)

  def per_list(self, labels, logits, weights=None, mask=None, generator=None):
    labels, logits, weights, mask = self._augmented(labels, logits, weights,
                                                    mask)
    return SoftmaxLoss.per_list(self, labels, logits, weights=weights,
                                mask=mask, generator=generator)


@dataclasses.dataclass(frozen=True)
class PolyOneSoftmaxLoss(SoftmaxLoss):
  """Poly-1 softmax: CE + epsilon * (1 - p_t) (Leng et al., ICLR'22;
  losses_impl.py:1200-1247)."""

  epsilon: float = 1.0

  def unreduced(self, labels, logits, mask=None, generator=None):
    label_dist, label_sum = _label_distribution(labels, mask)
    pt = torch.sum(label_dist * torch.softmax(logits, dim=-1), dim=-1)
    ce = softmax_cross_entropy(label_dist, logits)
    return ce + self.epsilon * (1.0 - pt), torch.reshape(label_sum, (-1,))


def _unique_softmax_fill(denom_logits: Tensor) -> Tensor:
  """The value under the masked entries of ``UniqueSoftmaxLoss``'s
  denominators: the minimum over the whole BATCH less 1e-3, as the JAX
  package has it (losses.py:490-491), not each row's."""
  return torch.amin(denom_logits) - 1e-3


@dataclasses.dataclass(frozen=True)
class UniqueSoftmaxLoss(_ListwiseLoss):
  """uRank unique-rating softmax (Zhu & Klabjan):
  -sum_i (2^l_i - 1) log softmax over {j : l_j < l_i} + {i}
  (losses_impl.py:1250-1281)."""

  def unreduced(self, labels, logits, mask=None, generator=None):
    if mask is None:
      mask = list_ops.is_label_valid(labels)
    labels = torch.where(mask, labels, 0.0)
    logits = torch.where(mask, logits, LOG_EPSILON)
    pairwise_labels, _ = pairwise_comparison(labels, logits, mask)
    # Item i's denominator: the logits of strictly lower-rated items and
    # its own.
    denom_logits = logits[:, None, :] * pairwise_labels
    denom_logits = torch.cat([denom_logits, logits[:, :, None]], dim=2)
    denom_mask = torch.cat(
        [pairwise_labels, torch.ones_like(logits)[:, :, None]], dim=2)
    denom_logits = torch.where(denom_mask > 0.0, denom_logits,
                               _unique_softmax_fill(denom_logits))
    logits_max = torch.amax(denom_logits, dim=-1, keepdim=True)
    denom_logits = denom_logits - logits_max
    shifted_logits = logits - torch.squeeze(logits_max, dim=-1)
    gains = torch.exp2(labels) - 1.0
    per_doc = -shifted_logits + torch.log(
        torch.sum(torch.exp(denom_logits) * denom_mask, dim=-1))
    losses = torch.sum(per_doc * gains, dim=1, keepdim=True)
    return losses, torch.ones_like(losses)


def _tie_breaking(generator: Optional[torch.Generator], shapes, device,
                  index: int = 0) -> dict:
  """The ``sort_by_scores`` arguments that break ties as the JAX package's
  keyed sort does: the generator, or without one the kept draws of seed 37
  (``shapes[index]`` of the one stream of draws of ``shapes``)."""
  if generator is not None:
    return {'generator': generator}
  return {'tie_draws': sorting.fixed_draws(_DEFAULT_SEED, shapes,
                                           device)[index]}


@dataclasses.dataclass(frozen=True)
class ListMLELoss(_ListwiseLoss):
  """ListMLE (Xia et al. 2008): the Plackett-Luce NLL of the label order
  (losses_impl.py:1541-1576). Label ties are broken at random: by the
  generator, or by the kept draws of seed 37."""

  def unreduced(self, labels, logits, mask=None, generator=None):
    if mask is None:
      mask = list_ops.is_label_valid(labels)
    labels = torch.where(mask, labels, 0.0)
    logits = torch.where(mask, logits, LOG_EPSILON)
    # Invalid items sort last by a fill of the ROW minimum less 1e-6
    # (losses.py:515-516), which equals that minimum in float32 once its
    # magnitude is large enough: the tie shuffle then decides.
    scores = torch.where(
        mask, labels, torch.amin(labels, dim=1, keepdim=True) - 1e-6)
    sorted_labels, sorted_logits = list_ops.sort_by_scores(
        scores, [labels, logits],
        **_tie_breaking(generator, [tuple(scores.shape)], scores.device))

    raw_max = torch.amax(sorted_logits, dim=1, keepdim=True)
    sorted_logits = sorted_logits - raw_max
    # Reverse cumulative logsumexp: log sum_{j >= i} exp(s_j) - s_i.
    sums = torch.flip(torch.cumsum(torch.flip(torch.exp(sorted_logits),
                                              [1]), dim=1), [1])
    sums = torch.log(sums) - sorted_logits

    if isinstance(self.lambda_weight, lw.ListMLELambdaWeight):
      batch, list_size = sorted_labels.shape
      positions = torch.arange(1, list_size + 1,
                               device=labels.device)[None, :].expand(
                                   batch, list_size)
      sums = sums * self.lambda_weight.individual_weights(sorted_labels,
                                                          positions)
    nll = torch.sum(sums, dim=1, keepdim=True)
    return nll, torch.ones_like(nll)


def _mask_to_min_offset(logits: Tensor, mask: Tensor) -> Tensor:
  """Pushes invalid logits 1e3 below the per-list min (Approx* sentinel)."""
  return torch.where(
      mask, logits, -1e3 + torch.amin(logits, dim=-1, keepdim=True))


def _standardize_logits(logits: Tensor, mask: Tensor,
                        temperature: float) -> Tensor:
  """Per-list masked standardization and sharpness for the Approx* losses.

  ``(s - mean) / (std * temperature)`` over the valid entries, which makes
  the loss invariant to the overall logit scale: the rank sigmoid sees
  score differences in units of the list's own std, so logit growth cannot
  saturate it (the JAX package's measurement: APPROX_NDCG_DIAG.json). The
  mean and std are differentiated through.
  """
  valid = mask.to(torch.float32)
  count = torch.clamp(torch.sum(valid, dim=-1, keepdim=True), min=1.0)
  mean = torch.sum(torch.where(mask, logits, 0.0), dim=-1,
                   keepdim=True) / count
  var = torch.sum(torch.where(mask, (logits - mean) ** 2, 0.0), dim=-1,
                  keepdim=True) / count
  std = torch.sqrt(var + 1e-12)
  return (logits - mean) / (std * temperature)


def _approx_inputs(labels, logits, mask, temperature, scale_invariant):
  if mask is None:
    mask = list_ops.is_label_valid(labels)
  labels = torch.where(mask, labels, 0.0)
  if scale_invariant:
    # __call__ already divided by the temperature; the standardization
    # cancels that (and any) scale, then applies the temperature as the
    # sharpness after normalization.
    logits = _standardize_logits(logits, mask, temperature)
  logits = _mask_to_min_offset(logits, mask)
  nonzero = torch.sum(labels, dim=1, keepdim=True) > 0.0
  labels = torch.where(nonzero, labels, EPSILON)
  return labels, logits, nonzero.to(torch.float32)


@dataclasses.dataclass(frozen=True)
class ApproxNDCGLoss(_ListwiseLoss):
  """-NDCG with sigmoid-approximated ranks (Qin et al.); temperature 0.1
  (losses_impl.py:1579).

  ``scale_invariant=True`` standardizes the logits of each list before the
  temperature (``_standardize_logits``): the loss registry's default for
  this key, at temperature 0.25 (``loss_registry.SCALE_INVARIANT_*``).
  """

  temperature: float = 0.1
  scale_invariant: bool = False

  def unreduced(self, labels, logits, mask=None, generator=None):
    labels, logits, nonzero = _approx_inputs(
        labels, logits, mask, self.temperature, self.scale_invariant)
    ranks = sorting.approx_ranks(logits)
    return -sorting.ndcg(labels, ranks), nonzero


@dataclasses.dataclass(frozen=True)
class ApproxMRRLoss(_ListwiseLoss):
  """-MRR with sigmoid-approximated ranks; temperature 0.1;
  ``scale_invariant`` as in ApproxNDCGLoss."""

  temperature: float = 0.1
  scale_invariant: bool = False

  def unreduced(self, labels, logits, mask=None, generator=None):
    labels, logits, nonzero = _approx_inputs(
        labels, logits, mask, self.temperature, self.scale_invariant)
    rr = 1.0 / sorting.approx_ranks(logits)
    rr = torch.sum(rr * labels, dim=-1, keepdim=True)
    mrr = rr / torch.sum(labels, dim=-1, keepdim=True)
    return -mrr, nonzero


@dataclasses.dataclass(frozen=True)
class NeuralSortCrossEntropyLoss(_ListwiseLoss):
  """CE between the NeuralSort permutation matrices of the labels and of
  the logits (losses_impl.py:1635-1673)."""

  def unreduced(self, labels, logits, mask=None, generator=None):
    if mask is None:
      mask = list_ops.is_label_valid(labels)
    labels = torch.where(mask, labels, 0.0)
    logits = torch.where(mask, logits, 0.0)
    nonzero = torch.sum(labels, dim=1, keepdim=True) > 0.0

    true_perm = sorting.neural_sort(labels, mask=mask)
    smooth_perm = sorting.neural_sort(logits, mask=mask)
    losses = softmax_cross_entropy(true_perm, torch.log(1e-20 + smooth_perm))

    # NeuralSort pins masked items to the trailing rows: zero those rows.
    sorted_mask = torch.sort(mask.to(torch.float32), dim=1,
                             descending=True).values.to(torch.bool)
    losses = torch.where(sorted_mask, losses, 0.0)
    valid_counts = torch.sum(mask.to(torch.float32), dim=-1, keepdim=True)
    losses = torch.where(
        valid_counts > 0,
        torch.sum(losses, dim=-1, keepdim=True)
        / torch.clamp(valid_counts, min=1.0), 0.0)
    return losses, nonzero.to(torch.float32)


@dataclasses.dataclass(frozen=True)
class NeuralSortNDCGLoss(_ListwiseLoss):
  """PiRank-NDCG: -expected NDCG under the NeuralSort soft permutation
  (losses_impl.py:1676-1713)."""

  def unreduced(self, labels, logits, mask=None, generator=None):
    if mask is None:
      mask = list_ops.is_label_valid(labels)
    labels = torch.where(mask, labels, 0.0)
    logits = torch.where(mask, logits, 0.0)
    nonzero = torch.sum(labels, dim=1, keepdim=True) > 0.0
    labels = torch.where(nonzero, labels, EPSILON)
    smooth_perm = sorting.neural_sort(logits, mask=mask)
    return (-sorting.ndcg(labels, perm_mat=smooth_perm),
            nonzero.to(torch.float32))


@dataclasses.dataclass(frozen=True)
class MixtureEMLoss(_ListwiseLoss):
  """EM over a mixture of scoring models; logits are ``[B, L, M]``
  (losses_impl.py:1472-1538)."""

  alpha: float = 1.0

  def unreduced(self, labels, logits, mask=None, generator=None):
    if mask is None:
      mask = list_ops.is_label_valid(labels)
    labels = torch.where(mask, labels, 0.0)
    # [B, L, M] per-model sigmoid CE (the M step), masked.
    losses = sigmoid_cross_entropy(labels[:, :, None], logits)
    losses = torch.where(mask[:, :, None], losses, 0.0)

    # E step: model responsibilities from each list's total log-odds.
    per_list_logodds = torch.sum(losses, dim=1, keepdim=True).detach()
    model_prob = torch.exp(-self.alpha * (
        per_list_logodds
        - torch.amin(per_list_logodds, dim=2, keepdim=True)))
    prob_norm = torch.sum(model_prob, dim=2, keepdim=True)

    nonzero = (torch.sum(labels, dim=1, keepdim=True) > 0.0).to(
        torch.float32)
    out = torch.sum(losses * model_prob / prob_norm, dim=(1, 2))
    return out[:, None], nonzero


@dataclasses.dataclass(frozen=True)
class CoupledRankDistilLoss(_ListwiseLoss):
  """Coupled RankDistil (Reddi et al. 2021): CE between k-Plackett-Luce
  models of the teacher's labels and the student's logits, estimated over
  Gumbel samples of teacher permutations (losses_impl.py:1984). The noise
  and then the tie shuffle draw from the generator, or without one from
  the kept draws of seed 37, in that order."""

  sample_size: int = 8
  topk: Optional[int] = None

  def unreduced(self, labels, logits, mask=None, generator=None):
    if mask is None:
      mask = list_ops.is_label_valid(labels)
    labels = torch.where(mask, labels, 0.0)
    nonzero = torch.sum(labels, dim=1, keepdim=True) > 0.0

    teacher = torch.where(mask, labels, LOG_EPSILON)
    student = torch.where(mask, logits, LOG_EPSILON)

    batch, list_size = labels.shape
    samples = batch * self.sample_size
    noise_shape = (batch, self.sample_size, list_size)
    noise = sorting.sample_gumbel(generator, noise_shape,
                                  device=logits.device, seed=_DEFAULT_SEED)
    sampled_teacher = teacher[:, None, :] + noise
    sampled_teacher = torch.log(torch.softmax(sampled_teacher, dim=-1)
                                + EPSILON)
    expanded_student = student[:, None, :].expand(noise_shape)

    # The student's scores in the sampled teacher permutations' order.
    sorted_student = list_ops.sort_by_scores(
        sampled_teacher.reshape(samples, list_size),
        [expanded_student.reshape(samples, list_size)],
        **_tie_breaking(generator, [noise_shape, (samples, list_size)],
                        logits.device, index=1))[0]

    topk = self.topk or list_size
    # logprob[i] = s_(i) - log(sum_{j >= i} exp(s_(j)) + i * eps): the
    # reference builds the denominator by REPLACING the i entries before
    # position i with log(eps) rather than dropping them, so each adds eps
    # to the sum (losses_impl.py:2088-2108).
    raw_max = torch.amax(sorted_student, dim=1, keepdim=True)
    shifted = sorted_student - raw_max
    rev_sum = torch.flip(torch.cumsum(torch.flip(torch.exp(shifted), [1]),
                                      dim=1), [1])
    replaced = torch.arange(list_size, dtype=torch.float32,
                            device=logits.device)[None, :]
    rev_lse = torch.log(rev_sum + replaced * EPSILON * torch.exp(-raw_max))
    logprob = (shifted - rev_lse)[:, :topk]
    logprob = torch.sum(logprob, dim=1).reshape(batch, self.sample_size)
    nll = torch.mean(-logprob, dim=1, keepdim=True)
    return nll, nonzero.to(torch.float32)


@dataclasses.dataclass(frozen=True)
class _PointwiseLoss(RankingLoss):
  """Pointwise family: one loss value per item."""

  def normalize_weights(self, labels, weights):
    if weights is None:
      weights = 1.0
    return torch.where(list_ops.is_label_valid(labels),
                       torch.ones_like(labels) * weights, 0.0)

  def per_list(self, labels, logits, weights=None, mask=None, generator=None):
    logits = self.get_logits(_float(logits))
    labels = _float(labels, logits)
    losses, loss_weights = self.unreduced(labels, logits, mask=mask,
                                          generator=generator)
    weights = self.normalize_weights(labels, weights) * loss_weights
    per_list_weights = torch.sum(weights, dim=1)
    per_list_losses = torch.sum(losses * weights, dim=1)
    per_list_losses = torch.where(
        per_list_weights > 0,
        per_list_losses / torch.clamp(per_list_weights, min=1e-38), 0.0)
    return per_list_losses, per_list_weights


@dataclasses.dataclass(frozen=True)
class SigmoidCrossEntropyLoss(_PointwiseLoss):
  """Per-item sigmoid CE (losses_impl.py:1425)."""

  def unreduced(self, labels, logits, mask=None, generator=None):
    if mask is None:
      mask = list_ops.is_label_valid(labels)
    labels = torch.where(mask, labels, 0.0)
    logits = torch.where(mask, logits, 0.0)
    return sigmoid_cross_entropy(labels, logits), mask.to(torch.float32)


@dataclasses.dataclass(frozen=True)
class MeanSquaredLoss(_PointwiseLoss):
  """Per-item squared error (losses_impl.py:1449)."""

  def unreduced(self, labels, logits, mask=None, generator=None):
    if mask is None:
      mask = list_ops.is_label_valid(labels)
    labels = torch.where(mask, labels, 0.0)
    logits = torch.where(mask, logits, 0.0)
    return torch.square(labels - logits), mask.to(torch.float32)


@dataclasses.dataclass(frozen=True)
class OrdinalLoss(_PointwiseLoss):
  """Ordinal regression: a sigmoid CE per level on ``[B, L, ordinal_size]``
  logits (losses_impl.py:1850-1918)."""

  ordinal_size: int = 1
  use_fraction_label: bool = False

  def _labels_to_ordinals(self, labels: Tensor, mask: Tensor) -> Tensor:
    one_to_n = torch.arange(1, self.ordinal_size + 1, dtype=torch.float32,
                            device=labels.device)
    unsqueezed = labels[:, :, None].expand(labels.shape + (self.ordinal_size,))
    ordinals = (unsqueezed >= one_to_n).to(torch.float32)
    if self.use_fraction_label:
      fractions = unsqueezed - one_to_n + 1.0
      fractions = torch.where((fractions > 0.0) & (fractions < 1.0),
                              fractions, 0.0)
      ordinals = ordinals + fractions
    return torch.where(mask[:, :, None], ordinals, 0.0)

  def unreduced(self, labels, logits, mask=None, generator=None):
    if logits.ndim != 3 or logits.shape[-1] != self.ordinal_size:
      raise ValueError(
          f'Ordinal loss expects logits [B, L, {self.ordinal_size}], got '
          f'{tuple(logits.shape)}.')
    if mask is None:
      mask = list_ops.is_label_valid(labels)
    labels = torch.where(mask, labels, 0.0)
    logits = torch.where(mask[:, :, None], logits, 0.0)
    ordinals = self._labels_to_ordinals(labels, mask)
    losses = torch.where(mask[:, :, None],
                         sigmoid_cross_entropy(ordinals, logits), 0.0)
    return torch.sum(losses, dim=-1), mask.to(torch.float32)


@dataclasses.dataclass(frozen=True)
class MultiClassLoss(_PointwiseLoss):
  """One-hot categorical CE with label smoothing on ``[B, L, C]``
  predictions (losses_impl.py:1921-1981). Without ``from_logits`` the
  predictions are non-negative scores, normalized per item."""

  num_classes: int = 2
  from_logits: bool = False
  label_smoothing: float = 0.0

  def unreduced(self, labels, logits, mask=None, generator=None):
    if logits.ndim != 3 or logits.shape[-1] != self.num_classes:
      raise ValueError(
          f'Multi-class loss expects logits [B, L, {self.num_classes}], got '
          f'{tuple(logits.shape)}.')
    if mask is None:
      mask = list_ops.is_label_valid(labels)
    labels = torch.where(mask, labels, 0.0)
    logits = torch.where(mask[:, :, None], logits, 0.0)
    # jax.nn.one_hot: a label outside [0, C) is a row of zeros.
    classes = (labels.to(torch.int64)[:, :, None] == torch.arange(
        self.num_classes, device=labels.device)).to(torch.float32)
    classes = torch.where(mask[:, :, None], classes, 0.0)
    if self.label_smoothing:
      classes = (classes * (1.0 - self.label_smoothing)
                 + self.label_smoothing / self.num_classes)
    if self.from_logits:
      losses = softmax_cross_entropy(classes, logits)
    else:
      total = torch.sum(logits, dim=-1, keepdim=True)
      probs = logits / torch.maximum(total, torch.full_like(total, 1e-7))
      probs = _clip(probs, 1e-7, 1.0 - 1e-7)
      losses = -torch.sum(classes * torch.log(probs), dim=-1)
    losses = losses * mask.to(torch.float32)
    return losses, mask.to(torch.float32)


@dataclasses.dataclass(frozen=True)
class ClickEMLoss(_PointwiseLoss):
  """Position-bias EM (Wang et al.): P(click) = P(examination) *
  P(relevance); logits are ``[B, L, 2]`` = (exam, rel). The E step's
  posteriors are computed in logit space and detached
  (losses_impl.py:1324-1422)."""

  exam_loss_weight: float = 1.0
  rel_loss_weight: float = 1.0

  def _latent_prob(self, clicks, exam_logits, rel_logits):
    is_clicked = clicks >= 1.0
    exam_posterior = exam_logits - _softplus(rel_logits)
    rel_posterior = rel_logits - _softplus(exam_logits)
    exam_prob = torch.where(is_clicked, 1.0, torch.sigmoid(exam_posterior))
    rel_prob = torch.where(is_clicked, 1.0, torch.sigmoid(rel_posterior))
    return exam_prob.detach(), rel_prob.detach()

  def unreduced(self, labels, logits, mask=None, generator=None):
    if mask is None:
      mask = list_ops.is_label_valid(labels)
    clicks = torch.where(mask, labels, 0.0)
    exam_logits = torch.where(mask, logits[..., 0], 0.0)
    rel_logits = torch.where(mask, logits[..., 1], 0.0)
    exam_prob, rel_prob = self._latent_prob(clicks, exam_logits, rel_logits)
    losses = (sigmoid_cross_entropy(exam_prob, exam_logits)
              * self.exam_loss_weight
              + sigmoid_cross_entropy(rel_prob, rel_logits)
              * self.rel_loss_weight)
    return losses, mask.to(torch.float32)
