"""Named gain and rank-discount functions shared by metrics.

The port's copy of the functions of ``ranking_tpu/utils/fns.py`` (the
reference's tensorflow_ranking/python/keras/utils.py:50-135), on tensors.
Its registry of names waits for the pipeline, which reads them.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

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

