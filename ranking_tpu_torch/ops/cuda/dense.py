"""Float32 dense products on the tensor cores for Hopper.

The engine of ``models.layers.DenseGeneral`` on the card. It replaces no
Pallas kernel: the JAX package leaves these products to XLA. It was added
because the encoder's dense products (query, key, value, attention output,
``Dense_0``, ``Dense_1``), forward and backward, are most of the BERT
cells' device time, and cuBLAS at float32's "highest" precision runs them
on the float32 pipes (67 TFLOP/s). The CUDA C++ kernel is
``csrc/dense.cu``: split TF32 on ``wgmma`` (three passes, about 22 of
float32's 24 bits, float32 sums), bound by operations at 165 TFLOP/s;
its header states the design.

``dense_general`` is a ``torch.autograd.Function``:

    y  = x W + b        (the bias added in the kernel's epilogue)
    dx = dy W^T         (the kernel, W read as it is stored)
    dW = x^T dy         (the kernel, A = x^T read from x; where dy is wider
                         than x, dW^T = dy^T x and the epilogue writes it
                         transposed, so the split pass reads the narrower)
    db = dy summed over rows

Each product goes through ``_product``, which launches the kernel for CUDA
tensors (or raises) and computes the same product, with the same operands
and orientations, in plain PyTorch for the rest (the CPU tests, gradcheck
in float64). ``dense_reference`` is the plain version of the forward.
``takes`` is the rule that decides which products ``DenseGeneral`` sends
here; the rest stay ``torch.tensordot``.
``dense_gemm.launches`` counts the kernel's launches, ``dense_gemm.flops``
the useful operations (2 m n k) they did.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from ranking_tpu_torch.ops.cuda import build

Tensor = torch.Tensor

# Tile rows (two consumer warpgroups of 64), tile columns and slice depth
# (csrc/dense.cu).
TILE_M, TILE_N, SLICE = 128, 192, 32
# A split of the depth keeps at least this many slices a split.
MIN_SLICES_A_SPLIT = 8
MAX_SPLITS = 16

# The routing rule (``takes``), from a sweep of a 768 -> 768 forward over
# rows against ``torch.addmm`` (ms, NVIDIA H100 80GB HBM3 at 700 W):
#
#   rows                 128     256     512     1024    2048    4096
#   graph replays        0.0184  0.0190  0.0201  0.0262  0.0365  0.0486
#     torch.addmm        0.0302  0.0257  0.0244  0.0403  0.0593  0.1285
#   eager (host too)     0.1787  0.0631  0.0585  0.0739  0.0694  0.0542
#     torch.addmm        0.0448  0.0270  0.0263  0.0422  0.0614  0.1293
#
# On the device the kernel wins from 128 rows up; called eagerly, its
# host side (the split pass's and the product's launches, three tensor
# maps) costs some 50 us a call, which the device time hides from about
# 2^30 multiply-adds (2,048 rows at 768 x 768) up. One rule serves both,
# since a captured step must compute what its eager warm-up computed: at
# least 2^30 multiply-adds and a full tile of rows.
MIN_ROWS = 128
MIN_MACS = 1 << 30

_lib = None
_SMS: Dict[int, int] = {}


def _kernel():
  global _lib
  if _lib is None:
    lib = build.load_library('dense')
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dense_split.argtypes = [p, ll, i, i, i, p, p, ll, p]
    lib.dense_split.restype = i
    lib.dense_gemm.argtypes = [p, ll, i, p, p, ll, p, p, ll, ll, p, i, i, i,
                               i, i, p]
    lib.dense_gemm.restype = i
    _lib = lib
  return _lib


def build_kernels() -> None:
  """Compiles and loads the kernel library (otherwise done at first use)."""
  _kernel()


def takes(device_type: str, dtype: torch.dtype, m: int, k: int,
          n: int) -> bool:
  """Whether ``DenseGeneral`` sends a product of ``m`` rows, depth ``k``
  and width ``n`` to the kernel: float32 on the card, both widths
  multiples of 4 (the TMA unit's 16-byte strides), and large enough to
  fill the card. bfloat16 (already on the tensor cores), the score head's
  N = 1, the pooler's few rows and other small products stay with
  ``torch.tensordot``."""
  return (device_type == 'cuda' and dtype == torch.float32
          and k % 4 == 0 and n % 4 == 0 and m >= MIN_ROWS
          and m * k * n >= MIN_MACS)


@functools.lru_cache(maxsize=256)
def plan(m: int, n: int, k: int, sms: int) -> Tuple[int, int]:
  """(depth splits, persistent blocks) for a product on ``sms`` SMs, from
  a model of the waves: a unit (a tile and a range of its depth) keeps an
  SM's tensor cores busy 12 clocks a column and slice (128 rows, 32 deep,
  3 passes at 1,024 TF32 multiply-adds a clock), the units run in
  ceil(units / sms) waves, and a split adds a pass over its partials at
  about 1,430 bytes a clock (2.5 TB/s at 1.75 GHz)."""
  slices = -(-k // SLICE)
  tiles = -(-m // TILE_M) * -(-n // TILE_N)
  best = None
  for splits in range(1, min(MAX_SPLITS,
                             max(1, slices // MIN_SLICES_A_SPLIT)) + 1):
    waves = -(-tiles * splits // sms)
    cost = waves * TILE_N * -(-slices // splits) * 12.0
    if splits > 1:
      cost += (splits + 1) * m * n * 4 / 1430.0
    if best is None or cost < best[0]:
      best = (cost, splits, min(tiles * splits, sms))
  return best[1:]


def _sms(device: torch.device) -> int:
  index = device.index if device.index is not None else (
      torch.cuda.current_device())
  if index not in _SMS:
    _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
  return _SMS[index]


def _aligned(t: Tensor) -> Tensor:
  """``t`` contiguous at a 16-byte aligned address (what the TMA unit
  reads)."""
  t = t.contiguous()
  return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(t: Tensor, what: str) -> None:
  if t.device.type != 'cuda' or t.dtype != torch.float32 or t.ndim != 2:
    raise ValueError(f'dense: {what} must be a 2-D float32 CUDA tensor, got '
                     f'{t.dtype} {tuple(t.shape)} on {t.device}')


def split_planes(src: Tensor, transpose: bool) -> Tuple[Tensor, Tensor, int]:
  """The hi and lo TF32 planes of B as the kernel reads them, ``[n, k]``
  K-major, and their row stride: ``src`` is B^T ``[n, k]`` (``transpose``
  False) or B ``[k, n]`` (True). Rows are padded to a multiple of 4."""
  _check(src, 'the split operand')
  src = _aligned(src)
  n, k = (src.shape[1], src.shape[0]) if transpose else src.shape
  if src.shape[1] % 4:
    raise ValueError(f'dense: the split operand\'s rows must be a multiple '
                     f'of 4 wide, got {tuple(src.shape)}')
  ldp = -(-k // 4) * 4
  planes = torch.empty((2, n, ldp), device=src.device, dtype=torch.float32)
  err = _kernel().dense_split(
      src.data_ptr(), src.shape[1], n, k, int(transpose),
      planes[0].data_ptr(), planes[1].data_ptr(), ldp,
      torch.cuda.current_stream(src.device).cuda_stream)
  if err != 0:
    raise RuntimeError(f'dense_split launch failed: CUDA error {err}')
  return planes[0], planes[1], ldp


def dense_gemm(a: Tensor, a_mmajor: bool, planes: Tuple[Tensor, Tensor, int],
               bias: Optional[Tensor], out: Tensor, transpose_out: bool,
               m: int, n: int, k: int) -> Tensor:
  """``out = A B (+ bias)`` through the kernel. ``a`` is A ``[m, k]``
  (``a_mmajor`` False) or A^T ``[k, m]`` (True); ``planes`` from
  ``split_planes``; ``out`` ``[m, n]``, or ``[n, m]`` receiving the
  product transposed (``transpose_out``). Returns ``out``."""
  _check(a, 'A')
  a = _aligned(a)
  if (a.shape != ((k, m) if a_mmajor else (m, k))) or a.shape[1] % 4:
    raise ValueError(f'dense: A {tuple(a.shape)} does not fit [{m}, {k}] '
                     f'(mmajor={a_mmajor}) with rows a multiple of 4 wide')
  if not out.is_contiguous() or out.data_ptr() % 16 or n % 2 or (
      out.shape != ((n, m) if transpose_out else (m, n))):
    raise ValueError('dense: out must be contiguous, aligned and of the '
                     'product\'s shape')
  if bias is not None:
    if (bias.device != a.device or bias.dtype != torch.float32
        or bias.shape != (n,)):
      raise ValueError(f'dense: the bias must be a float32 tensor of {n} '
                       f'on {a.device}, got {bias.dtype} '
                       f'{tuple(bias.shape)} on {bias.device}')
    bias = bias.contiguous()
  splits, grid = plan(m, n, k, _sms(a.device))
  partial = (torch.empty((splits, m, n), device=a.device,
                         dtype=torch.float32) if splits > 1 else None)
  rs, cs = (1, m) if transpose_out else (n, 1)
  hi, lo, ldb = planes
  err = _kernel().dense_gemm(
      a.data_ptr(), a.shape[1], int(a_mmajor), hi.data_ptr(), lo.data_ptr(),
      ldb, None if bias is None else bias.data_ptr(), out.data_ptr(), rs, cs,
      None if partial is None else partial.data_ptr(), m, n, k, splits,
      grid, torch.cuda.current_stream(a.device).cuda_stream)
  if err != 0:
    raise RuntimeError(f'dense_gemm launch failed: CUDA error {err}')
  dense_gemm.launches += 1
  dense_gemm.flops += 2 * m * n * k
  return out


dense_gemm.launches = 0
dense_gemm.flops = 0

KERNEL_WRAPPERS = (dense_gemm,)


def reset_launches() -> None:
  dense_gemm.launches = 0
  dense_gemm.flops = 0


# ---------------------------------------------------------------------------
# The plain version and the autograd function
# ---------------------------------------------------------------------------


def dense_reference(x: Tensor, w: Tensor, bias: Optional[Tensor]) -> Tensor:
  """Plain version: ``x [m, k] @ w [k, n] (+ bias [n])``."""
  y = x @ w
  return y if bias is None else y + bias


def _product(a: Tensor, a_mmajor: bool, b: Tensor, b_kmajor: bool,
             bias: Optional[Tensor], transpose_out: bool) -> Tensor:
  """A B (+ bias), ``[m, n]``, or its transpose ``[n, m]`` where
  ``transpose_out``: A is ``a`` ``[m, k]``, or ``a``^T where ``a_mmajor``;
  B is ``b`` ``[k, n]``, or ``b``^T where ``b_kmajor`` (``b`` ``[n, k]``,
  the planes' own layout, so the split pass need not transpose it). The
  kernel for CUDA tensors; plain PyTorch for the rest."""
  m, k = (a.shape[1], a.shape[0]) if a_mmajor else a.shape
  n = b.shape[0] if b_kmajor else b.shape[1]
  if a.device.type != 'cuda':
    y = (a.t() if a_mmajor else a) @ (b.t() if b_kmajor else b)
    y = y if bias is None else y + bias
    return y.t() if transpose_out else y
  out = torch.empty((n, m) if transpose_out else (m, n), device=a.device,
                    dtype=torch.float32)
  return dense_gemm(a, a_mmajor, split_planes(b, not b_kmajor), bias, out,
                    transpose_out, m, n, k)


def _forward(x: Tensor, w: Tensor, bias: Optional[Tensor]) -> Tensor:
  return _product(x, False, w, False, bias, False)


def _input_grad(dy: Tensor, w: Tensor) -> Tensor:
  # dx = dy W^T: W [k, n] is B^T, read as it is stored.
  return _product(dy, False, w, True, None, False)


def _weight_grad(x: Tensor, dy: Tensor) -> Tensor:
  if dy.shape[1] <= x.shape[1]:
    # dW = x^T dy: the split pass reads dy.
    return _product(x, True, dy, False, None, False)
  # dW^T = dy^T x, written transposed: the split pass reads x.
  return _product(dy, True, x, False, None, True)


class _Dense(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x: Tensor, w: Tensor, bias: Optional[Tensor]) -> Tensor:
    ctx.save_for_backward(x, w)
    ctx.has_bias = bias is not None
    return _forward(x, w, bias)

  @staticmethod
  def backward(ctx, dy: Tensor):
    x, w = ctx.saved_tensors
    dy = dy.contiguous()
    dx = _input_grad(dy, w) if ctx.needs_input_grad[0] else None
    dw = _weight_grad(x, dy) if ctx.needs_input_grad[1] else None
    db = (dy.sum(0) if ctx.has_bias and ctx.needs_input_grad[2] else None)
    return dx, dw, db


def dense_general(x: Tensor, kernel: Tensor, bias: Optional[Tensor],
                  n_in: int) -> Tensor:
  """flax's ``DenseGeneral`` product: ``kernel``'s leading ``n_in`` axes
  contracted with ``x``'s trailing ones, ``bias`` (of the kernel's output
  shape, or None) added; through ``_Dense``."""
  out_shape = kernel.shape[n_in:]
  k = math.prod(kernel.shape[:n_in])
  n = math.prod(out_shape)
  y = _Dense.apply(x.reshape(-1, k), kernel.reshape(k, n),
                   None if bias is None else bias.reshape(n))
  return y.reshape(tuple(x.shape[:x.ndim - n_in]) + tuple(out_shape))
