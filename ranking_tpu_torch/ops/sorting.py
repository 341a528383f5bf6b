"""Ranks and ideal-DCG normalizers for the lambda weights.

The port's copy of the parts of ``ranking_tpu/ops/sorting.py`` that the
pairwise losses and their lambda weights use (the reference's
tensorflow_ranking/python/losses_impl.py:33-49, 109-134, 483-500):
``safe_gains``, ``compute_ranks`` and ``inverse_max_dcg``. The smooth
relaxations of that file (approx ranks, NeuralSort, Gumbel sampling) wait
for the losses that use them.

Conventions: logits and labels are ``[B, L]`` float32, ``is_valid`` is
``[B, L]`` bool. Randomness is an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, Optional

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
