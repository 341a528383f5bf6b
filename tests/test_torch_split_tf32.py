"""The split-TF32 arithmetic of the fused masked-BN tower's products.

The CUDA engine (``ranking_tpu_torch/ops/cuda/csrc/fused_bn_common.cuh``)
runs every product of the tower on the tensor cores in TF32, which keeps 10
of float32's 23 mantissa bits. For float32 accuracy it writes each operand
as ``x = hi + lo`` (``hi = tf32(x)``, ``lo = tf32(x - hi)``) and sums
``hi_a lo_b + lo_a hi_b + hi_a hi_b`` a slice of 32 depths at a time, 8
depths a tensor-core step, the small terms first, adding each slice to a
float32 total. This file models that in plain PyTorch on the CPU and holds
it to the float32 tolerance of the kernels' check (``chip_smoke.FUSED_TOL``:
1e-5 of the output's largest value) against a float64 product.
"""

import numpy as np
import pytest
import torch

_TOL = 1e-5    # chip_smoke.FUSED_TOL['float32'], tests/test_torch_cuda.py
_SLICE = 32    # fused_bn_common.cuh: kBK
_STEP = 8      # the depth of one TF32 tensor-core step (m64nNk8)


def _tf32(x):
  """x rounded to TF32: the 13 low mantissa bits rounded away, to nearest
  with ties away from zero, as the kernel's ``to_tf32`` does on the bits."""
  bits = x.contiguous().view(torch.int32)
  return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _product(a, b, passes):
  """a [M, K] @ b [K, N] in the kernel's order of terms: per slice, per
  step, hi lo, lo hi, then hi hi (three passes) or hi hi alone (one)."""
  a_hi, b_hi = _tf32(a), _tf32(b)
  a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
  total = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
  for k0 in range(0, a.shape[1], _SLICE):
    part = torch.zeros_like(total)
    for k in range(k0, min(k0 + _SLICE, a.shape[1]), _STEP):
      s = slice(k, k + _STEP)
      if passes == 3:
        part = part + a_hi[:, s] @ b_lo[s]
        part = part + a_lo[:, s] @ b_hi[s]
      part = part + a_hi[:, s] @ b_hi[s]
    total = total + part
  return total


def _rel_err(got, a, b):
  want = a.double() @ b.double()
  return ((got.double() - want).abs().max() / want.abs().max()).item()


def _tower_operands(kind):
  """Operands of the tower's products at small shapes with the flagship's
  value scales (log1p features, W ~ N(0, 1 / F_in), BN-folded ReLU
  activations, dy of a softmax loss's scale)."""
  rng = np.random.default_rng(0)
  if kind == 'forward':           # y = relu(z) W, F_in = 1024
    z = np.maximum(rng.standard_normal((128, 1024)), 0.0)
    w = rng.standard_normal((1024, 64)) / np.sqrt(1024)
    a, b = z, w
  elif kind == 'first layer':     # y = x W at F_0 = 136, heavy-tailed x
    x = np.exp(2.0 * rng.standard_normal((128, 136)))
    x = np.sign(rng.standard_normal(x.shape)) * np.log1p(x)
    a, b = x, rng.standard_normal((136, 96)) / np.sqrt(136)
  else:                           # dW^T = dy^T z over 2048 rows
    dy = rng.standard_normal((2048, 48)) * 1e-3
    z = np.maximum(rng.standard_normal((2048, 80)), 0.0)
    a, b = dy.T, z
  return (torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)),
          torch.from_numpy(np.ascontiguousarray(b, dtype=np.float32)))


@pytest.mark.parametrize('kind', ['forward', 'first layer', 'over rows'])
def test_three_passes_hold_the_float32_tolerance(kind):
  a, b = _tower_operands(kind)
  assert _rel_err(_product(a, b, passes=3), a, b) <= _TOL


@pytest.mark.parametrize('kind', ['forward', 'first layer', 'over rows'])
def test_one_tf32_pass_does_not(kind):
  a, b = _tower_operands(kind)
  assert _rel_err(_product(a, b, passes=1), a, b) > _TOL


@pytest.mark.parametrize('kind', ['forward', 'first layer', 'over rows'])
def test_one_pass_is_exact_on_bf16_operands(kind):
  a, b = (t.to(torch.bfloat16).to(torch.float32)
          for t in _tower_operands(kind))
  # bf16 keeps 8 mantissa bits, TF32 10: rounding to TF32 changes nothing,
  # so one pass multiplies exactly the operands three passes would.
  assert torch.equal(_tf32(a), a) and torch.equal(_tf32(b), b)
  assert torch.equal(_product(a, b, passes=1), _product(a, b, passes=3))
  assert _rel_err(_product(a, b, passes=1), a, b) <= _TOL


def test_tf32_rounds_to_nearest_with_ties_away_from_zero():
  one = torch.tensor([1.0])
  ulp = 2.0 ** -10                # TF32's unit in the last place at 1
  x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 2 - 2 ** -20,
                    1.0 + 1.5 * ulp])
  want = torch.tensor([1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + 2 * ulp])
  assert torch.equal(_tf32(x), want)
  assert torch.equal(_tf32(one), one)
  # hi + lo holds x to about 2^-21 of its size.
  v = torch.from_numpy(np.random.default_rng(1).standard_normal(4096)
                       .astype(np.float32))
  hi = _tf32(v)
  lo = _tf32(v - hi)
  assert ((hi.double() + lo.double() - v.double()).abs()
          <= 2.0 ** -21 * v.double().abs()).all()
