"""Fused Dense -> masked BatchNorm -> ReLU tower (train mode) for Hopper.

Counterpart of ``ranking_tpu/ops/pallas/fused_bn.py``. The hidden chain of
the scoring tower runs as one hand-written CUDA kernel per layer and
direction (``csrc/fused_bn_fwd.cu``, ``csrc/fused_bn_bwd.cu``; their headers
state the functions, the design and the bounds), behind a
``torch.autograd.Function``:

* forward, per layer: ``y = relu?(x * s + t) @ W + b`` with the layer
  below's BN fold and ReLU applied while ``x`` is loaded, and this layer's
  masked column sum and sum of squares from the same pass;
* backward: the top layer's reduction terms in one pass (``_bwd_stats``);
  per layer ``dy = s * dyhat - mask * (y * c2 + c1)`` rebuilt on the fly,
  ``dx = dy @ W^T``, ``dW = z^T @ dy`` and the layer below's reduction
  terms (``_bwd_mats``); the first layer's ``dW`` folded into layer 1's
  call as ``A = x0^T dyhat0`` and ``B = x0^T (mask * y0)``; the first
  layer's ``dx`` (``_bwd_dx_only``) only where the input needs a gradient,
  and its ``dW`` alone (``_bwd_dw_only``) for a one-layer tower.

Statistics are the exact mask-weighted moments in float32, with the fast
variance ``max(0, E[y^2] - E[y]^2)`` and eps inside the root; with an
all-ones mask this is flax's ``Dense -> BatchNorm -> relu`` in train mode.

Each of the five functions has a wrapper that launches its kernel for CUDA
tensors and computes its plain PyTorch version (``*_reference``) for CPU
tensors, and counts its launches in ``.launches``. A CUDA call that a
kernel cannot take raises; nothing falls back to the plain version on the
card. ``plain_versions()`` forces the plain versions on any device, for
holding the kernels against them.

Weights are taken as ``[F_in, F_out]`` (the JAX package's layout) with any
strides: the tower passes ``linear.weight.t()``, a view, and the kernels
read it through its strides, so no transposed copy is made. ``dW`` comes
back as the transposed view of a contiguous ``[F_out, F_in]`` tensor, the
parameter's own layout.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from ranking_tpu_torch.ops.cuda import build

Tensor = torch.Tensor

# Blocks that the row-reducing products aim for: one wave of an H100's
# 132 multiprocessors, one block each (a block's 256 threads hold over 200
# registers each, and its ring of shared memory is 130 KB).
_TARGET_BLOCKS = 132
_TILE = 128        # csrc/fused_bn_common.cuh: kBM, and the usual tile width
_WIDE_TILE = 136   # one tile across 129..136 output columns (F_0 = 136)
_SLICE_DEPTH = 32  # kBK
_STAT_ROWS = 256   # csrc/fused_bn_bwd.cu: kStatRowsPerBlock

_FORCED: Optional[bool] = None  # None = fused for CUDA tensors only
_PLAIN = False
_libs = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def set_enabled(value: Optional[bool]) -> None:
  """True forces the fused tower on any device (on the CPU through the
  plain versions, for tests); False disables it; None restores the default
  (fused when the tower's input is a CUDA tensor)."""
  global _FORCED
  _FORCED = value


def enabled(x: Tensor) -> bool:
  if _FORCED is not None:
    return _FORCED
  return x.device.type == 'cuda'


def eligible(training: bool, use_batch_norm: bool, input_batch_norm: bool,
             dropout: float, activation: str, dtype: torch.dtype,
             x: Tensor) -> bool:
  """Whether this tower configuration takes the fused path (shared by
  ``Tower`` and the scorer, which picks its padding strategy by it)."""
  return bool(training
              and use_batch_norm
              and not input_batch_norm
              and not dropout
              and activation == 'relu'
              and dtype in (torch.float32, torch.bfloat16)
              and x.dtype == torch.float32
              and x.ndim == 2
              and enabled(x))


@contextlib.contextmanager
def plain_versions():
  """Inside, every wrapper computes its plain PyTorch version, on any
  device. For comparing the kernels with them; the port never uses it."""
  global _PLAIN
  prev, _PLAIN = _PLAIN, True
  try:
    yield
  finally:
    _PLAIN = prev


def _use_kernel(x: Tensor) -> bool:
  if _PLAIN or x.device.type == 'cpu':
    return False
  if x.device.type != 'cuda':
    raise ValueError(f'no fused BN kernels for device {x.device}')
  return True


def _lib(name: str):
  lib = _libs.get(name)
  if lib is not None:
    return lib
  lib = build.load_library(name)
  lib.fused_bn_weight_tiles_bytes.argtypes = [_I, _I, _I]
  lib.fused_bn_weight_tiles_bytes.restype = _L
  if name == 'fused_bn_fwd':
    lib.fused_bn_layer_forward.argtypes = [
        _P, _I, _P, _P, _P, _P, _I, _L, _L, _P, _P, _P, _I, _P, _P, _P,
        _I, _I, _I, _I, _P]
    lib.fused_bn_layer_forward.restype = _I
  else:
    lib.fused_bn_bwd_stats.argtypes = [_P, _P, _I, _P, _P, _P, _P, _P, _I,
                                       _I, _P]
    lib.fused_bn_bwd_dx.argtypes = [
        _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _L, _L, _P, _P, _I, _P, _P,
        _P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _P]
    lib.fused_bn_bwd_dw.argtypes = [
        _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I,
        _P, _P, _I, _I, _I, _P]
    lib.fused_bn_bwd_ab.argtypes = [
        _P, _P, _I, _P, _I, _P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _P]
    for fn in (lib.fused_bn_bwd_stats, lib.fused_bn_bwd_dx,
               lib.fused_bn_bwd_dw, lib.fused_bn_bwd_ab):
      fn.restype = _I
    for fn in (lib.fused_bn_stat_rows, lib.fused_bn_slice_depth):
      fn.argtypes, fn.restype = [], _I
    if (lib.fused_bn_stat_rows() != _STAT_ROWS
        or lib.fused_bn_slice_depth() != _SLICE_DEPTH):
      raise RuntimeError('csrc/fused_bn_bwd.cu and fused_bn.py disagree on '
                         'the block shapes')
  lib.fused_bn_tile_rows.argtypes, lib.fused_bn_tile_rows.restype = [], _I
  if lib.fused_bn_tile_rows() != _TILE:
    raise RuntimeError(f'csrc/{name}.cu and fused_bn.py disagree on the '
                       'tile size')
  _libs[name] = lib
  return lib


def build_kernels() -> None:
  """Compiles and loads both kernel libraries (otherwise done at first
  use)."""
  build.compile_libraries(['fused_bn_fwd', 'fused_bn_bwd'])
  _lib('fused_bn_fwd')
  _lib('fused_bn_bwd')


def _cdiv(a: int, b: int) -> int:
  return -(-a // b)


def _tile_cols(cols: int) -> int:
  """Output tile width the kernels take for ``cols`` output columns
  (``fbn::tile_cols``)."""
  return _WIDE_TILE if _TILE < cols <= _WIDE_TILE else _TILE


def row_splits(n: int, n_i: int, n_j: int) -> Tuple[int, int]:
  """(splits, chunk_rows) of a product that reduces over ``n`` rows into
  an ``[n_i, n_j]`` output: enough row chunks to fill the card, each a
  multiple of the staged slice depth."""
  tiles = _cdiv(n_i, _TILE) * _cdiv(n_j, _tile_cols(n_j))
  splits = max(1, min(_TARGET_BLOCKS // tiles, _cdiv(n, _TILE)))
  chunk = _cdiv(_cdiv(n, splits), _SLICE_DEPTH) * _SLICE_DEPTH
  return _cdiv(n, chunk), chunk


def _is_bf16(t: Tensor) -> int:
  if t.dtype == torch.bfloat16:
    return 1
  if t.dtype == torch.float32:
    return 0
  raise ValueError(f'float32 or bfloat16 expected, got {t.dtype}')


def _rows(t: Tensor, name: str, n: Optional[int] = None) -> Tensor:
  """A contiguous 2-D float32/bfloat16 CUDA matrix (with ``n`` rows)."""
  if t.ndim != 2 or (n is not None and t.shape[0] != n):
    raise ValueError(f'{name}: [N, F] with N={n} expected, got '
                     f'{tuple(t.shape)}')
  _is_bf16(t)
  return t.contiguous()


def _vec(t: Tensor, f: int, name: str) -> Tensor:
  if t.shape != (f,):
    raise ValueError(f'{name}: [{f}] expected, got {tuple(t.shape)}')
  return t.to(torch.float32).contiguous()


def _mask_vec(mask_col: Tensor, n: int) -> Tensor:
  if mask_col.numel() != n:
    raise ValueError(f'mask: {n} rows expected, got {tuple(mask_col.shape)}')
  return mask_col.reshape(n).to(torch.float32).contiguous()


def _weight(w: Tensor, dtype: torch.dtype) -> Tensor:
  """``w`` in ``dtype``, row-major or the transpose of a row-major matrix
  (the kernels read either through its strides; other views are copied)."""
  w = w.to(dtype)
  rows, cols = w.shape
  if ((w.stride(1) == 1 and w.stride(0) >= cols)
      or (w.stride(0) == 1 and w.stride(1) >= rows)):
    return w
  return w.contiguous()


def _weight_tiles(lib, k: int, n: int, w: Tensor) -> Tensor:
  """Scratch for the kernels' copy of a K x N weight, split for the tensor
  cores and laid out in their tiles (``split_weight`` in
  csrc/fused_bn_common.cuh)."""
  size = lib.fused_bn_weight_tiles_bytes(k, n, _is_bf16(w))
  return torch.empty((size,), dtype=torch.uint8, device=w.device)


def _check(err: int, what: str) -> None:
  if err != 0:
    raise RuntimeError(f'{what} launch failed: CUDA error {err}')


def _stream(t: Tensor):
  return torch.cuda.current_stream(t.device).cuda_stream


def _f32(t: Tensor) -> Tensor:
  return t.to(torch.float32)


def _as(t: Tensor, dtype: torch.dtype) -> Tensor:
  """Rounds to ``dtype`` and returns float32: the operand of a product in
  ``dtype`` with float32 accumulation."""
  return t.to(dtype).to(torch.float32)


# ---------------------------------------------------------------------------
# Row 2: one layer forward
# ---------------------------------------------------------------------------


def layer_forward_reference(x, mask_col, s_in, t_in, w, b, *, relu_in: bool,
                            act_dtype=torch.float32):
  """Plain PyTorch version of ``layer_forward``."""
  z = _f32(x) * s_in + t_in
  if relu_in:
    z = torch.relu(z)
  y = _as(z, act_dtype) @ _as(w, act_dtype) + b
  ym = y * _f32(mask_col).reshape(-1, 1)
  return y.to(act_dtype), ym.sum(0), (ym * y).sum(0)


def layer_forward(x, mask_col, s_in, t_in, w, b, *, relu_in: bool,
                  act_dtype=torch.float32):
  """``y = relu?(x * s_in + t_in) @ w + b`` and its masked column moments.

  Args:
    x: ``[N, F_in]`` float32 or bfloat16.
    mask_col: ``[N]`` or ``[N, 1]`` row weights of the statistics.
    s_in, t_in: ``[F_in]`` fold of the layer below (ones and zeros for the
      first layer).
    w: ``[F_in, F_out]``, any strides; b: ``[F_out]``.
    act_dtype: storage type of ``y`` (float32 or bfloat16). With bfloat16
      the product's operands are rounded to it and summed in float32, and
      the moments come from the float32 ``y``.

  Returns:
    ``(y [N, F_out] act_dtype, col_sum [F_out], col_ssq [F_out])``.
  """
  if not _use_kernel(x):
    return layer_forward_reference(x, mask_col, s_in, t_in, w, b,
                                   relu_in=relu_in, act_dtype=act_dtype)
  x = _rows(x, 'x')
  n, f_in = x.shape
  if w.ndim != 2 or w.shape[0] != f_in:
    raise ValueError(f'w: [{f_in}, F_out] expected, got {tuple(w.shape)}')
  f_out = w.shape[1]
  w = _weight(w, act_dtype)
  mask = _mask_vec(mask_col, n)
  s_in, t_in = _vec(s_in, f_in, 's_in'), _vec(t_in, f_in, 't_in')
  b = _vec(b, f_out, 'b')
  y = torch.empty((n, f_out), dtype=act_dtype, device=x.device)
  partial = torch.empty((2, _cdiv(n, _TILE), f_out), dtype=torch.float32,
                        device=x.device)
  col_sum = torch.empty((f_out,), dtype=torch.float32, device=x.device)
  col_ssq = torch.empty_like(col_sum)
  lib = _lib('fused_bn_fwd')
  w_tiles = _weight_tiles(lib, f_in, f_out, w)
  with torch.cuda.device(x.device):
    _check(lib.fused_bn_layer_forward(
        x.data_ptr(), _is_bf16(x), mask.data_ptr(), s_in.data_ptr(),
        t_in.data_ptr(), w.data_ptr(), _is_bf16(w), w.stride(0), w.stride(1),
        w_tiles.data_ptr(), b.data_ptr(), y.data_ptr(), _is_bf16(y),
        partial.data_ptr(), col_sum.data_ptr(), col_ssq.data_ptr(), n, f_in,
        f_out, int(relu_in), _stream(x)), 'fused_bn_layer_forward')
  layer_forward.launches += 1
  return y, col_sum, col_ssq


layer_forward.launches = 0


# ---------------------------------------------------------------------------
# Row 3: the top layer's reduction terms
# ---------------------------------------------------------------------------


def bwd_stats_reference(g, y, s, t):
  """Plain PyTorch version of ``bwd_stats``."""
  g, y = _f32(g), _f32(y)
  dyhat = torch.where(y * s + t > 0, g, 0.0)
  return dyhat.sum(0), (dyhat * y).sum(0)


def bwd_stats(g, y, s, t):
  """``s1 = sum dyhat``, ``s2 = sum dyhat * y`` over ALL rows, with
  ``dyhat = g * [y * s + t > 0]``; g, y ``[N, F]`` -> two ``[F]`` float32.
  (Unmasked: every row's output depends on the statistics.)"""
  if not _use_kernel(y):
    return bwd_stats_reference(g, y, s, t)
  y = _rows(y, 'y')
  n, f = y.shape
  g = _rows(g.to(y.dtype), 'g', n)
  s, t = _vec(s, f, 's'), _vec(t, f, 't')
  partial = torch.empty((2, _cdiv(n, _STAT_ROWS), f), dtype=torch.float32,
                        device=y.device)
  s1 = torch.empty((f,), dtype=torch.float32, device=y.device)
  s2 = torch.empty_like(s1)
  lib = _lib('fused_bn_bwd')
  with torch.cuda.device(y.device):
    _check(lib.fused_bn_bwd_stats(
        g.data_ptr(), y.data_ptr(), _is_bf16(y), s.data_ptr(), t.data_ptr(),
        partial.data_ptr(), s1.data_ptr(), s2.data_ptr(), n, f, _stream(y)),
           'fused_bn_bwd_stats')
  bwd_stats.launches += 1
  return s1, s2


bwd_stats.launches = 0


# ---------------------------------------------------------------------------
# Rows 4, 5, 6: the matrix products of the backward
# ---------------------------------------------------------------------------


def _dy_reference(g, y, mask_col, s, t, c1, c2):
  g, y = _f32(g), _f32(y)
  dyhat = torch.where(y * s + t > 0, g, 0.0)
  return s * dyhat - _f32(mask_col).reshape(-1, 1) * (y * c2 + c1)


def bwd_mats_reference(g, y, mask_col, s, t, c1, c2, x_in, s_in, t_in, w, *,
                       relu_in: bool, emit_prev_stats: bool, x0=None,
                       emit_dx: bool = True):
  """Plain PyTorch version of ``bwd_mats``."""
  act_dtype = y.dtype
  dy = _as(_dy_reference(g, y, mask_col, s, t, c1, c2), act_dtype)
  dx = dy @ _as(w, act_dtype).t()
  x_in32 = _f32(x_in)
  zhat = x_in32 * s_in + t_in
  z = torch.relu(zhat) if relu_in else zhat
  dw = _as(z, act_dtype).t() @ dy
  s1 = s2 = None
  outs = [dx.to(act_dtype) if emit_dx else None, dw]
  if emit_prev_stats:
    dyhat_prev = torch.where(zhat > 0, dx, 0.0)
    s1, s2 = dyhat_prev.sum(0), (dyhat_prev * x_in32).sum(0)
  outs += [s1, s2]
  if x0 is not None:
    x0 = _as(x0, act_dtype)
    m = _f32(mask_col).reshape(-1, 1)
    outs += [x0.t() @ _as(dyhat_prev, act_dtype),
             x0.t() @ _as(m * x_in32, act_dtype)]
  return tuple(outs)


def _dy_inputs(g, y, mask_col, s, t, c1, c2):
  """Checks the operands of a dy rebuild. Returns the tensors (to keep them
  alive across the launch) and the kernels' leading arguments for them."""
  y = _rows(y, 'y')
  n, f_out = y.shape
  g = _rows(g.to(y.dtype), 'g', n)
  mask = _mask_vec(mask_col, n)
  s, t, c1, c2 = (_vec(v, f_out, k) for v, k in
                  ((s, 's'), (t, 't'), (c1, 'c1'), (c2, 'c2')))
  keep = (g, y, mask, s, t, c1, c2)
  return keep, (g.data_ptr(), y.data_ptr(), _is_bf16(y), mask.data_ptr(),
                s.data_ptr(), t.data_ptr(), c1.data_ptr(), c2.data_ptr())


def _ptr(t: Optional[Tensor]):
  return None if t is None else t.data_ptr()


def _launch_dx(dy_args, y, w, below=None, dx=None, dyhat_prev=None):
  """``dx = dy @ w^T`` into ``dx`` (if given); with ``below = (x_in, s_in,
  t_in)`` also that layer's ``(s1, s2)``, and its gated ``dyhat_prev`` (if
  given)."""
  n, f_out = y.shape
  f_in = w.shape[0]
  new = lambda *shape: torch.empty(  # noqa: E731
      shape, dtype=torch.float32, device=y.device)
  x_in = s_in = t_in = s1 = s2 = partial = None
  if below is not None:
    x_in, s_in, t_in = below
    s1, s2, partial = new(f_in), new(f_in), new(2, _cdiv(n, _TILE), f_in)
  lib = _lib('fused_bn_bwd')
  w_tiles = _weight_tiles(lib, f_out, f_in, w)
  _check(lib.fused_bn_bwd_dx(
      *dy_args, w.data_ptr(), _is_bf16(w), w.stride(0), w.stride(1),
      w_tiles.data_ptr(), _ptr(x_in), 0 if x_in is None else _is_bf16(x_in), _ptr(s_in),
      _ptr(t_in), _ptr(dx), 0 if dx is None else _is_bf16(dx),
      _ptr(dyhat_prev), 0 if dyhat_prev is None else _is_bf16(dyhat_prev),
      _ptr(partial), _ptr(s1), _ptr(s2), n, f_in, f_out, _stream(y)),
         'fused_bn_bwd_dx')
  return s1, s2


def _launch_dw(dy_args, y, x_in, s_in, t_in, relu_in: bool) -> Tensor:
  """``dW = z^T @ dy`` as the transposed view of a ``[F_out, F_in]``."""
  n, f_out = y.shape
  f_in = x_in.shape[1]
  splits, chunk = row_splits(n, f_out, f_in)
  dw_t = torch.empty((f_out, f_in), dtype=torch.float32, device=y.device)
  partial = (torch.empty((splits, f_out, f_in), dtype=torch.float32,
                         device=y.device) if splits > 1 else dw_t)
  _check(_lib('fused_bn_bwd').fused_bn_bwd_dw(
      *dy_args, x_in.data_ptr(), _is_bf16(x_in), s_in.data_ptr(),
      t_in.data_ptr(), int(relu_in), _is_bf16(y), splits, chunk,
      partial.data_ptr(), dw_t.data_ptr(), n, f_in, f_out, _stream(y)),
         'fused_bn_bwd_dw')
  return dw_t.t()


def bwd_mats(g, y, mask_col, s, t, c1, c2, x_in, s_in, t_in, w, *,
             relu_in: bool, emit_prev_stats: bool, x0=None,
             emit_dx: bool = True):
  """One layer's backward products.

  Rebuilds ``dy`` from ``(g, y)`` and returns ``(dx, dW, s1, s2)`` or, with
  ``x0``, ``(dx, dW, s1, s2, A, B)``:

  * ``dx = dy @ w^T`` ``[N, F_in]`` in y's type (None unless ``emit_dx``);
  * ``dW = z^T @ dy`` ``[F_in, F_out]`` float32, ``z = relu?(x_in * s_in +
    t_in)``;
  * ``s1, s2``: the layer below's reduction terms from ``dx`` gated by that
    layer's pre-activation (None unless ``emit_prev_stats``);
  * ``A = x0^T @ dyhat_prev``, ``B = x0^T @ (mask * x_in)`` ``[F_0, F_in]``:
    the row-reducing products of the first layer's ``dW``.
  """
  if x0 is not None and not emit_prev_stats:
    raise ValueError('x0 (the first-layer fold) needs emit_prev_stats')
  if not emit_dx and x0 is None:
    raise ValueError('dx is the only feed of the layer below without x0')
  if not _use_kernel(y):
    return bwd_mats_reference(g, y, mask_col, s, t, c1, c2, x_in, s_in, t_in,
                              w, relu_in=relu_in,
                              emit_prev_stats=emit_prev_stats, x0=x0,
                              emit_dx=emit_dx)
  keep, dy_args = _dy_inputs(g, y, mask_col, s, t, c1, c2)
  y, mask = keep[1], keep[2]
  n, f_out = y.shape
  x_in = _rows(x_in, 'x_in', n)
  f_in = x_in.shape[1]
  if w.shape != (f_in, f_out):
    raise ValueError(f'w: [{f_in}, {f_out}] expected, got {tuple(w.shape)}')
  w = _weight(w, y.dtype)
  s_in, t_in = _vec(s_in, f_in, 's_in'), _vec(t_in, f_in, 't_in')
  new = lambda *shape, dtype=torch.float32: torch.empty(  # noqa: E731
      shape, dtype=dtype, device=y.device)
  dx = new(n, f_in, dtype=y.dtype) if emit_dx else None
  # dyhat of the layer below goes through device memory to reach the A
  # product (see csrc/fused_bn_bwd.cu).
  dyhat_prev = new(n, f_in, dtype=y.dtype) if x0 is not None else None
  with torch.cuda.device(y.device):
    s1, s2 = _launch_dx(dy_args, y, w,
                        (x_in, s_in, t_in) if emit_prev_stats else None, dx,
                        dyhat_prev)
    outs = (dx, _launch_dw(dy_args, y, x_in, s_in, t_in, relu_in), s1, s2)
    if x0 is not None:
      x0 = _rows(x0.to(torch.float32), 'x0', n)
      f_0 = x0.shape[1]
      splits, chunk = row_splits(n, f_in, f_0)
      a_t, b_t = new(f_in, f_0), new(f_in, f_0)
      partial = new(splits, f_in, f_0) if splits > 1 else a_t
      bf16 = _is_bf16(y)
      _check(_lib('fused_bn_bwd').fused_bn_bwd_ab(
          x0.data_ptr(), dyhat_prev.data_ptr(), bf16, x_in.data_ptr(),
          _is_bf16(x_in), mask.data_ptr(), bf16, splits, chunk,
          partial.data_ptr(), a_t.data_ptr(), b_t.data_ptr(), n, f_0, f_in,
          _stream(y)), 'fused_bn_bwd_ab')
      outs += (a_t.t(), b_t.t())
  bwd_mats.launches += 1
  return outs


bwd_mats.launches = 0


def bwd_dx_only_reference(g, y, mask_col, s, t, c1, c2, w):
  """Plain PyTorch version of ``bwd_dx_only``."""
  dy = _as(_dy_reference(g, y, mask_col, s, t, c1, c2), y.dtype)
  return dy @ _as(w, y.dtype).t()


def bwd_dx_only(g, y, mask_col, s, t, c1, c2, w):
  """The first layer's input gradient ``dx = dy @ w^T`` ``[N, F_0]``
  float32: its own call, made only where the input needs a gradient."""
  if not _use_kernel(y):
    return bwd_dx_only_reference(g, y, mask_col, s, t, c1, c2, w)
  keep, dy_args = _dy_inputs(g, y, mask_col, s, t, c1, c2)
  y = keep[1]
  n, f_out = y.shape
  if w.ndim != 2 or w.shape[1] != f_out:
    raise ValueError(f'w: [F_in, {f_out}] expected, got {tuple(w.shape)}')
  w = _weight(w, y.dtype)
  dx = torch.empty((n, w.shape[0]), dtype=torch.float32, device=y.device)
  with torch.cuda.device(y.device):
    _launch_dx(dy_args, y, w, dx=dx)
  bwd_dx_only.launches += 1
  return dx


bwd_dx_only.launches = 0


def bwd_dw_only_reference(g, y, mask_col, s, t, c1, c2, x_in, s_in, t_in, *,
                          relu_in: bool):
  """Plain PyTorch version of ``bwd_dw_only``."""
  dy = _as(_dy_reference(g, y, mask_col, s, t, c1, c2), y.dtype)
  z = _f32(x_in) * s_in + t_in
  if relu_in:
    z = torch.relu(z)
  return _as(z, y.dtype).t() @ dy


def bwd_dw_only(g, y, mask_col, s, t, c1, c2, x_in, s_in, t_in, *,
                relu_in: bool):
  """``dW = z^T @ dy`` ``[F_in, F_out]`` float32 alone, with no ``dx`` and
  no reduction terms: the first layer of a tower that has no layer 1 to
  fold it into."""
  if not _use_kernel(y):
    return bwd_dw_only_reference(g, y, mask_col, s, t, c1, c2, x_in, s_in,
                                 t_in, relu_in=relu_in)
  keep, dy_args = _dy_inputs(g, y, mask_col, s, t, c1, c2)
  y = keep[1]
  x_in = _rows(x_in, 'x_in', y.shape[0])
  f_in = x_in.shape[1]
  s_in, t_in = _vec(s_in, f_in, 's_in'), _vec(t_in, f_in, 't_in')
  with torch.cuda.device(y.device):
    dw = _launch_dw(dy_args, y, x_in, s_in, t_in, relu_in)
  bwd_dw_only.launches += 1
  return dw


bwd_dw_only.launches = 0

KERNEL_WRAPPERS = (layer_forward, bwd_stats, bwd_mats, bwd_dx_only,
                   bwd_dw_only)


def reset_launches() -> None:
  for fn in KERNEL_WRAPPERS:
    fn.launches = 0


# ---------------------------------------------------------------------------
# The fused tower op
# ---------------------------------------------------------------------------


def _bn_fold(col_sum, col_ssq, gamma, beta, n, eps: float):
  mu = col_sum / n
  var = torch.clamp(col_ssq / n - mu * mu, min=0.0)
  sig_inv = torch.rsqrt(var + eps)
  s = gamma * sig_inv
  t = beta - mu * s
  return mu, var, sig_inv, s, t


def _layer_consts(fold, s1, s2, col_sum, n, local=None):
  """Per-column BN backward constants and parameter gradients of a layer.

  Under data parallelism ``s1, s2, col_sum, n`` are the sums over the data
  group, which the constants need, and ``local`` this rank's own
  ``(s1, s2, col_sum, n)``: the parameter gradients are linear in them, so
  each rank returns its share and the data group's gradient all-reduce
  sums the shares."""
  mu, _, sig_inv, s, _ = fold
  dbeta = s1
  dgamma = (s2 - mu * s1) * sig_inv
  c2 = s * sig_inv * dgamma / n
  c1 = s * (s1 / n - mu * sig_inv * dgamma / n)
  if local is not None:
    s1, s2, col_sum, n = local
    dbeta = s1
    dgamma = (s2 - mu * s1) * sig_inv
  db = s * s1 - col_sum * c2 - n * c1
  return dbeta, dgamma, c1, c2, db


def _sum_over(group, *terms):
  """The terms summed over the data group, in one all-reduce (the terms
  themselves where there is no group)."""
  from ranking_tpu_torch.parallel import comm
  if group is None:
    return list(terms)
  sizes = [t.numel() for t in terms]
  flat = comm.all_reduce(torch.cat([t.reshape(-1) for t in terms]), group)
  return [x.view_as(t) for x, t in zip(torch.split(flat, sizes), terms)]


class _FusedBnMlp(torch.autograd.Function):
  """``(x, mask, eps, act_dtype, group, *weights, *biases, *gammas, *betas)
  -> (a_last, *means, *vars)``; weights in the parameter layout
  ``[F_out, F_in]``. Means and vars are not differentiable.

  ``group``: the data group of a data-parallel step, or None. With one,
  ``x`` is this rank's rows of the global batch, and the moments are the
  global batch's: each layer's column sums, sums of squares and valid
  count are summed over the group between the launches, and in the
  backward so are the reduction terms that row 3 gives and row 4 emits.
  The kernels do not change."""

  @staticmethod
  def forward(ctx, x, mask, eps, act_dtype, group, *params):
    num_layers = len(params) // 4
    weights, bs, gammas, betas = (params[i * num_layers:(i + 1) * num_layers]
                                  for i in range(4))
    x = x.detach()
    mask_col = mask.detach().to(torch.float32).reshape(-1, 1)
    n_local = mask_col.sum()
    (n,) = _sum_over(group, n_local)
    n = torch.clamp(n, min=1.0)
    f_0 = x.shape[1]
    s_in = torch.ones((f_0,), dtype=torch.float32, device=x.device)
    t_in = torch.zeros((f_0,), dtype=torch.float32, device=x.device)
    ys, sums, local_sums, folds = [], [], [], []
    h, relu_in = x, False
    for weight, b, gamma, beta in zip(weights, bs, gammas, betas):
      y, col_sum, col_ssq = layer_forward(
          h, mask_col, s_in, t_in, weight.detach().t(), b.detach(),
          relu_in=relu_in, act_dtype=act_dtype)
      local_sums.append(col_sum)
      col_sum, col_ssq = _sum_over(group, col_sum, col_ssq)
      fold = _bn_fold(col_sum, col_ssq, gamma.detach(), beta.detach(), n, eps)
      ys.append(y)
      sums.append(col_sum)
      folds.append(fold)
      h, s_in, t_in, relu_in = y, fold[3], fold[4], True
    a_last = torch.relu(_f32(ys[-1]) * folds[-1][3] + folds[-1][4])
    a_last = a_last.to(act_dtype)
    means = tuple(f[0] for f in folds)
    vars_ = tuple(f[1] for f in folds)
    ctx.fused = (x, mask_col, n, ys, sums, folds,
                 [w.detach() for w in weights])
    ctx.group = group
    ctx.local = (n_local, local_sums)
    ctx.mark_non_differentiable(*means, *vars_)
    return (a_last, *means, *vars_)

  @staticmethod
  def backward(ctx, g_a, *_):
    x, mask_col, n, ys, sums, folds, weights = ctx.fused
    group = ctx.group
    n_local, local_sums = ctx.local
    num_layers = len(ys)
    input_grad = ctx.needs_input_grad[0]
    g = g_a
    d_ws: List[Optional[Tensor]] = [None] * num_layers
    d_bs = list(d_ws)
    d_gammas = list(d_ws)
    d_betas = list(d_ws)

    # The top layer's reduction terms need their own pass; every lower
    # layer's arrive with the products of the layer above.
    top = num_layers - 1
    s1, s2 = bwd_stats(g, ys[top], folds[top][3], folds[top][4])
    # The first layer's dW rides in layer 1's call whenever there is one.
    fold_dw0 = num_layers >= 2
    a0 = b0 = dx0 = None
    for l in range(top, -1, -1):
      fold = folds[l]
      local = None if group is None else (s1, s2, local_sums[l], n_local)
      s1, s2 = _sum_over(group, s1, s2)
      dbeta, dgamma, c1, c2, db = _layer_consts(fold, s1, s2, sums[l], n,
                                                local)
      d_bs[l], d_gammas[l], d_betas[l] = db, dgamma, dbeta
      s, t = fold[3], fold[4]
      w = weights[l].t()
      if l == 0:
        if a0 is not None:
          # dW0 = s0 * A - c2_0 * B - c1_0 * (x^T m).
          xm = (x * mask_col).sum(0)
          d_ws[l] = a0 * s - b0 * c2 - xm[:, None] * c1
        else:
          ones = torch.ones((x.shape[1],), dtype=torch.float32,
                            device=x.device)
          d_ws[l] = bwd_dw_only(g, ys[l], mask_col, s, t, c1, c2, x, ones,
                                torch.zeros_like(ones), relu_in=False)
        if input_grad:
          dx0 = bwd_dx_only(g, ys[l], mask_col, s, t, c1, c2, w)
      else:
        last_fold = l == 1 and fold_dw0
        outs = bwd_mats(
            g, ys[l], mask_col, s, t, c1, c2, ys[l - 1], folds[l - 1][3],
            folds[l - 1][4], w, relu_in=True, emit_prev_stats=True,
            x0=x if last_fold else None,
            emit_dx=input_grad or not last_fold)
        if last_fold:
          g, d_ws[l], s1, s2, a0, b0 = outs
        else:
          g, d_ws[l], s1, s2 = outs
    grads = ([dw.t().contiguous() for dw in d_ws] + d_bs + d_gammas
             + d_betas)
    return (dx0, None, None, None, None, *grads)


def fused_bn_mlp(x, mask, weights: Sequence[Tensor], bs: Sequence[Tensor],
                 gammas: Sequence[Tensor], betas: Sequence[Tensor],
                 eps: float = 1e-5, act_dtype=torch.float32,
                 input_grad: bool = True):
  """``relu(maskedBN(h @ W_l^T + b_l))`` chained over layers.

  Args:
    x: ``[N, F_0]`` float32 rows (documents).
    mask: ``[N]`` row validity (any dtype). Statistics are the exact
      moments over rows weighted by it; all rows still produce outputs.
    weights: per-layer ``[F_out, F_in]`` (``nn.Linear.weight``); bs, gammas,
      betas: per-layer ``[F_out]``.
    eps: BN epsilon.
    act_dtype: storage type of the hidden activations.
    input_grad: False is a ``detach()`` on ``x``: the backward then neither
      computes the input gradient nor writes layer 1's ``dx``.

  Returns:
    ``(a_last [N, F_L] act_dtype, means tuple, vars tuple)``; means and
    vars are for the running averages and carry no gradient.
  """
  if len(weights) == 0 or not (len(weights) == len(bs) == len(gammas)
                               == len(betas)):
    raise ValueError('one weight, bias, gamma and beta per layer expected')
  if x.ndim != 2 or x.dtype != torch.float32:
    raise ValueError(f'x: [N, F] float32 expected, got {tuple(x.shape)} '
                     f'{x.dtype}')
  if not input_grad:
    x = x.detach()
  num_layers = len(weights)
  from ranking_tpu_torch.parallel import comm
  outs = _FusedBnMlp.apply(x, mask, float(eps), act_dtype, comm.data_group(),
                           *weights, *bs, *gammas, *betas)
  return (outs[0], tuple(outs[1:1 + num_layers]),
          tuple(outs[1 + num_layers:]))


def reference_bn_mlp(x, weights, bs, gammas, betas, eps: float = 1e-5,
                     mask=None):
  """Plain PyTorch mirror of ``fused_bn_mlp`` for autograd: Linear ->
  train-mode masked BatchNorm (fast variance, clip, float32) -> relu."""
  h = x
  if mask is None:
    m = torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)
  else:
    m = mask.to(x.dtype).reshape(x.shape[0], 1)
  n = torch.clamp(m.sum(), min=1.0)
  means, vars_ = [], []
  for weight, b, gamma, beta in zip(weights, bs, gammas, betas):
    y = h @ weight.t() + b
    mu = (y * m).sum(0) / n
    var = torch.clamp((y * y * m).sum(0) / n - mu * mu, min=0.0)
    h = torch.relu((y - mu) * torch.rsqrt(var + eps) * gamma + beta)
    means.append(mu)
    vars_.append(var)
  return h, tuple(means), tuple(vars_)
