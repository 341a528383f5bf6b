"""Named gain and rank-discount functions shared by metrics.

The port's copy of ``ranking_tpu/utils/fns.py`` (the reference's
tensorflow_ranking/python/keras/utils.py:50-135), on tensors, with its
registry of names (``get_gain_fn``, ``get_rank_discount_fn``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

Tensor = torch.Tensor
ScalarFn = Callable[[Tensor], Tensor]

# A 0-d tensor, so that log(2) / x is one true division as in the JAX
# package (a Python float on the left would become reciprocal(x) * log(2),
# rounded twice). It mixes with tensors of any device and float type.
_LOG2 = torch.tensor(math.log(2.0), dtype=torch.float64)


def identity(x: Tensor) -> Tensor:
  """f(x) = x."""
  return x


def inverse(rank: Tensor) -> Tensor:
  """f(rank) = 1 / rank."""
  return 1.0 / rank


def pow_minus_1(label: Tensor) -> Tensor:
  """f(label) = 2^label - 1 (the default DCG gain)."""
  return torch.pow(2.0, label) - 1.0


def log2_inverse(rank: Tensor) -> Tensor:
  """f(rank) = log(2) / log(1 + rank) (the default DCG discount)."""
  return _LOG2 / torch.log1p(rank)


def log1p_inverse(rank: Tensor) -> Tensor:
  """f(rank) = 1 / log(1 + rank) (natural-log DCG discount)."""
  return 1.0 / torch.log1p(rank)


def is_greater_equal_1(label: Tensor) -> Tensor:
  """f(label) = I[label >= 1] as float."""
  return (label >= 1.0).to(torch.float32)


def symmetric_log1p(x: Tensor) -> Tensor:
  """f(x) = sign(x) * log(1 + |x|)."""
  return torch.sign(x) * torch.log1p(torch.abs(x))



GAIN_FNS: Dict[str, ScalarFn] = {
    'identity': identity,
    'pow_minus_1': pow_minus_1,
    'is_greater_equal_1': is_greater_equal_1,
    'symmetric_log1p': symmetric_log1p,
}

RANK_DISCOUNT_FNS: Dict[str, ScalarFn] = {
    'inverse': inverse,
    'log2_inverse': log2_inverse,
    'log1p_inverse': log1p_inverse,
}


def get_gain_fn(name: str) -> ScalarFn:
  if name not in GAIN_FNS:
    raise ValueError(f'Unknown gain fn {name!r}; choices: {list(GAIN_FNS)}')
  return GAIN_FNS[name]


def get_rank_discount_fn(name: str) -> ScalarFn:
  if name not in RANK_DISCOUNT_FNS:
    raise ValueError(
        f'Unknown rank discount fn {name!r}; choices: '
        f'{list(RANK_DISCOUNT_FNS)}')
  return RANK_DISCOUNT_FNS[name]
