"""Ranks, ideal-DCG normalizers and differentiable ranking relaxations.

The port's copy of ``ranking_tpu/ops/sorting.py`` (the reference's
tensorflow_ranking/python/losses_impl.py:33-167, 483-649, 1716-1847):
``safe_gains``, ``compute_ranks`` and ``inverse_max_dcg`` for the lambda
weights, and the O(L^2) building blocks of the Approx* and NeuralSort
losses: ``approx_ranks``, ``ndcg``, ``neural_sort``, Gumbel sampling
(``sample_gumbel``, ``gumbel_neural_sort``, ``gumbel_sample_lists``).
``approx_ranks`` is a plain ``[B, L, L]`` expression: the JAX package
retired its kernel (no faster than the fused expression).

Conventions: logits and labels are ``[B, L]`` float32, ``is_valid`` and
``mask`` are ``[B, L]`` bool. Randomness is an explicit ``torch.Generator``.
Where the JAX package falls back to a fixed key for ``key=None``, the port
draws from ``fixed_draws``: numbers drawn once for each shape and device
from a generator seeded as that key, and kept, so that every call without a
generator draws the same numbers (and a CUDA graph captured after the first
call finds them on the card). They are not JAX's threefry numbers.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ranking_tpu_torch.utils import fns, list_ops

Tensor = torch.Tensor


def safe_gains(labels: Tensor) -> Tensor:
  """Overflow-safe 2^l - 1 style gains, shifted by the per-list max label.

  gains_i = 2^(l_i - max_l) - 2^(-max_l); the shift cancels in any
  normalized (NDCG-style) ratio while keeping the exponents bounded.
  """
  max_labels = torch.amax(labels, dim=-1, keepdim=True)
  return torch.exp2(labels - max_labels) - torch.exp2(-max_labels)


def compute_ranks(
    logits: Tensor,
    is_valid: Tensor,
    generator: Optional[torch.Generator] = None,
) -> Tensor:
  """1-based int32 ranks of items by logit, with invalid items ranked last.

  Invalid logits are replaced by (row min - 1e-6) before ranking. In
  float32 that equals the row min once the min's magnitude passes about 8,
  so the lowest valid item then ties with the invalid ones and the tie
  rule (position, or the generator's shuffle) decides its rank: the JAX
  package's behaviour, kept as it is.
  """
  logits = logits.detach()
  scores = torch.where(
      is_valid, logits, torch.amin(logits, dim=1, keepdim=True) - 1e-6)
  return list_ops.sorted_ranks(scores, generator=generator)


def inverse_max_dcg(
    labels: Tensor,
    gain_fn: Callable[[Tensor], Tensor] = fns.pow_minus_1,
    rank_discount_fn: Callable[[Tensor], Tensor] = fns.log1p_inverse,
    topn: Optional[int] = None,
) -> Tensor:
  """``[B, 1]`` multiplier 1/maxDCG, 0 where the ideal DCG is 0.

  The labels are a float channel sorted by themselves, so on the card this
  is one launch of the sort kernel.
  """
  ideal_sorted, = list_ops.sort_by_scores(labels, [labels], topn=topn)
  ranks = torch.arange(1, ideal_sorted.shape[1] + 1, dtype=torch.float32,
                       device=labels.device)
  discounted = gain_fn(ideal_sorted) * rank_discount_fn(ranks)[None, :]
  ideal_dcg = torch.sum(discounted, dim=1, keepdim=True)
  return torch.where(ideal_dcg > 0.0, 1.0 / ideal_dcg,
                     torch.zeros_like(ideal_dcg))


# (seed, shapes, device) -> the kept draws of ``fixed_draws``.
_FIXED: Dict[tuple, List[Tensor]] = {}


def fixed_draws(seed: int, shapes: Sequence[Tuple[int, ...]],
                device) -> List[Tensor]:
  """Uniform [0, 1) float32 draws of each of ``shapes`` in turn from one CPU
  generator seeded ``seed``, on ``device``: made at the first call for
  (seed, shapes, device) and kept, so that later calls return the same
  tensors without drawing or copying."""
  device = torch.device(device)
  key = (seed, tuple(tuple(s) for s in shapes), str(device))
  if key not in _FIXED:
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
      raise RuntimeError(
          f'fixed draws of {key} made inside a CUDA graph capture: run the '
          'step once before capturing it')
    gen = torch.Generator().manual_seed(seed)
    _FIXED[key] = [torch.rand(tuple(s), generator=gen).to(device)
                   for s in shapes]
  return _FIXED[key]


def approx_ranks(logits: Tensor) -> Tensor:
  """Sigmoid-smoothed ranks: rank_i = 0.5 + sum_j sigmoid(s_j - s_i).

  The j == i term contributes exactly 0.5, so rank_i smoothly approximates
  1 + |{j : s_j > s_i}| (losses_impl.py:77-106). Temperature is applied by
  the caller via logit scaling.
  """
  pairs = torch.sigmoid(logits[:, None, :] - logits[:, :, None])
  return torch.sum(pairs, dim=-1) + 0.5


def ndcg(labels: Tensor, ranks: Optional[Tensor] = None,
         perm_mat: Optional[Tensor] = None) -> Tensor:
  """``[B, 1]`` NDCG with safe gains, from (possibly soft) ranks or a
  permutation matrix.

  ``ranks=None`` takes the labels to be in rank order. ``perm_mat`` is a
  ``[B, L, L]`` row-stochastic matrix (rows ranks, columns items), giving the
  expected NDCG under that soft permutation (losses_impl.py:137-167). The
  ideal DCG sorts the labels: one launch of the sort kernel on the card.
  """
  if ranks is not None and perm_mat is not None:
    raise ValueError('Pass at most one of ranks and perm_mat.')
  list_size = labels.shape[1]
  if ranks is None:
    ranks = torch.arange(1, list_size + 1, dtype=torch.float32,
                         device=labels.device)[None, :]
  if not ranks.is_floating_point():
    ranks = ranks.to(torch.float32)
  discounts = 1.0 / torch.log1p(ranks)
  gains = safe_gains(labels.to(torch.float32))
  if perm_mat is not None:
    gains = torch.sum(perm_mat * gains[:, None, :], dim=-1)
  dcg = torch.sum(gains * discounts, dim=-1, keepdim=True)
  return dcg * inverse_max_dcg(labels, gain_fn=safe_gains)


def neural_sort(logits: Tensor, mask: Optional[Tensor] = None,
                temperature: float = 1.0) -> Tensor:
  """Differentiable ``[B, L, L]`` permutation matrix via NeuralSort (Grover
  et al. 2019).

  P_hat[b, k, i] = softmax_i(((n + 1 - 2k) * s_i - sum_j |s_i - s_j|) / t),
  mask-aware: the rows of invalid items are moved to the bottom by a stable
  argsort of the mask (the valid rows keep their order), and a row of an
  invalid rank spreads its probability evenly over the invalid items
  (losses_impl.py:1716-1801).
  """
  if mask is None:
    mask = torch.ones_like(logits, dtype=torch.bool)
  mask = mask.to(torch.bool)
  return torch.softmax(neural_sort_exponents(logits, mask) / temperature,
                       dim=-1)


def neural_sort_exponents(logits: Tensor, mask: Tensor) -> Tensor:
  """The ``[B, L, L]`` exponents of ``neural_sort`` before the temperature
  and the softmax: ``(n + 1 - 2k) * s_i - sum_j |s_i - s_j|`` over the valid
  items, ``-inf`` where one of a row's rank and item is invalid, 0 where
  both are, the rows of invalid ranks moved to the bottom."""
  logits = torch.where(mask, logits, 0.0)
  num_valid = torch.sum(mask.to(torch.int32), dim=1, keepdim=True)

  logit_diff = torch.abs(logits[:, :, None] - logits[:, None, :])
  valid_pair = mask[:, :, None] & mask[:, None, :]
  logit_diff = torch.where(valid_pair, logit_diff, 0.0)
  # [B, 1, L]: the sum over the first pair axis.
  diff_sum = torch.sum(logit_diff, dim=1, keepdim=True)

  # Rank coefficients over valid positions only.
  masked_range = torch.cumsum(mask.to(torch.int32), dim=1)
  scaling = (num_valid + 1 - 2 * masked_range).to(torch.float32)
  p_logits = scaling[:, :, None] * logits[:, None, :] - diff_sum

  p_logits = torch.where(valid_pair, p_logits, -math.inf)
  either_valid = mask[:, :, None] | mask[:, None, :]
  p_logits = torch.where(either_valid, p_logits, 0.0)

  order = torch.argsort(-mask.to(torch.int32), dim=1, stable=True)
  return torch.gather(p_logits, 1, order[:, :, None].expand(p_logits.shape))


def sample_gumbel(generator: Optional[torch.Generator],
                  shape: Tuple[int, ...], eps: float = 1e-20,
                  device=None, seed: int = 17) -> Tensor:
  """Standard Gumbel(0, 1) noise -log(-log U) of ``shape`` on ``device``
  (the generator's by default). ``generator=None`` takes the kept draws of
  ``seed`` (``fixed_draws``): 17 is the loss factory's fallback key."""
  if generator is None:
    u = fixed_draws(seed, [shape], 'cpu' if device is None else device)[0]
  else:
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32,
                   device=generator.device)
    u = u if device is None else u.to(device)
  return -torch.log(-torch.log(u + eps) + eps)


def gumbel_neural_sort(logits: Tensor,
                       generator: Optional[torch.Generator] = None,
                       sample_size: int = 8,
                       temperature: float = 1.0) -> Tensor:
  """``[B, S, L, L]`` stochastic NeuralSort over Gumbel-perturbed logits
  (losses_impl.py:1804-1847)."""
  batch, list_size = logits.shape
  noise = sample_gumbel(generator, (batch, sample_size, list_size),
                        device=logits.device)
  sampled = (logits[:, None, :] + noise).reshape(batch * sample_size,
                                                 list_size)
  perm = neural_sort(sampled / temperature)
  return perm.reshape(batch, sample_size, list_size, list_size)


def gumbel_sample_lists(
    labels: Tensor,
    logits: Tensor,
    generator: Optional[torch.Generator] = None,
    weights: Optional[Tensor] = None,
    sample_size: int = 8,
    temperature: float = 1.0,
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
  """Expands a batch to ``batch * sample_size`` Gumbel-resampled lists.

  Labels (and weights) are tiled; logits become the masked log-softmax of
  Gumbel-perturbed logits, the Concrete-distribution trick of every
  ``gumbel_*`` loss (losses_impl.py:540-644). Takes 2-D labels and 3-D
  (``[B, L, S]`` subtopic) labels.
  """
  batch, list_size = logits.shape
  expanded_labels = labels[:, None].expand(
      (batch, sample_size) + tuple(labels.shape[1:])).reshape(
          (batch * sample_size,) + tuple(labels.shape[1:]))

  noise = sample_gumbel(generator, (batch, sample_size, list_size),
                        device=logits.device)
  sampled_logits = (logits[:, None, :] + noise).reshape(
      batch * sample_size, list_size)

  valid = list_ops.is_label_valid(expanded_labels)
  if valid.ndim > 2:
    valid = torch.any(valid, dim=-1)
  sampled_logits = torch.where(valid, sampled_logits / temperature,
                               math.log(1e-20))
  sampled_logits = torch.log(torch.softmax(sampled_logits, dim=-1) + 1e-20)

  expanded_weights = None
  if weights is not None:
    weights = torch.as_tensor(weights, device=logits.device).to(
        torch.float32)
    if weights.ndim == 1:
      weights = weights[:, None]
    expanded_weights = weights[:, None, :].expand(
        batch, sample_size, weights.shape[1]).reshape(
            batch * sample_size, -1)
  return expanded_labels, sampled_logits, expanded_weights
