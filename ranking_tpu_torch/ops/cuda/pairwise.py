"""Fused pairwise ranking-loss sums for Hopper, forward and backward.

Counterpart of ``ranking_tpu/ops/pallas/pairwise.py`` (``_pairwise_sums_fwd``
and ``_pairwise_sums_bwd``) and of the dispatcher ``maybe_fused_pairwise`` in
``ranking_tpu/ops/pallas/__init__.py``. The plain pairwise losses
(``ops/losses.py``) form ``[B, L, L]`` tensors of logit differences,
preference labels, lambda weights and losses. The kernels of
``csrc/pairwise.cu`` (its header states the function, the design and the
bound) compute per list the three sums that every reduction needs, with the
pair matrices nowhere in memory:

* ``pairwise_sums_forward -> [B, 3]``: sum of loss x pair weight, sum of
  pair weights, count of non-zero pair weights;
* ``pairwise_sums_backward -> [B, L]``: the gradient of the first sum with
  respect to the logits (pair weights carry no gradient, as in the plain
  path, and the other two sums have none).

Each has a wrapper that launches its kernel for CUDA tensors and computes
its plain PyTorch version (``pairwise_sums_reference``,
``pairwise_sums_grad_reference``) for CPU tensors, and counts its launches
in ``.launches``. A CUDA call that a kernel cannot take raises; nothing
falls back to the plain version on the card. ``plain_versions()`` forces
the plain versions on any device, for holding the kernels against them.

``maybe_fused_pairwise`` is what ``_PairwiseLoss.__call__`` asks first. It
returns None for the configurations the kernels do not cover (dispatch by
configuration, the JAX package's own rule) and the loss then takes its
``[B, L, L]`` path: ``PairwiseMSELoss``, an unknown lambda weight, a rank
discount that is not one of the named functions of ``utils/fns.py``, a DCG
mode with an explicit mask, labels that are not 2-D, ``Reduction.NONE``.

Lists of up to ``MAX_LIST_SIZE`` items fit the kernels' shared memory; a
longer list on the card raises unless ``set_enabled(False)`` chose the plain
path.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional, Tuple

import torch

from ranking_tpu_torch.ops.cuda import build

Tensor = torch.Tensor

LOSS_LOGISTIC = 0
LOSS_HINGE = 1
LOSS_SOFT_ZERO_ONE = 2

LAMBDA_NONE = 0
LAMBDA_LABELDIFF = 1
LAMBDA_DCG_V2 = 2
LAMBDA_DCG_V1 = 3           # smooth_fraction mix + topn pair mask
LAMBDA_DCG_V2_NEIGHBOR = 4  # YetiDCGLambdaWeight: V2 x (|r_i - r_j| == 1)

DISCOUNT_LOG2_INVERSE = 0   # D(r) = log(2) / log(1 + r)
DISCOUNT_INVERSE = 1        # D(r) = 1 / r
DISCOUNT_LOG1P_INVERSE = 2  # D(r) = 1 / log(1 + r)

# Items of one list whose per-item arrays fit a block's shared memory
# (csrc/pairwise.cu: kMaxListSize).
MAX_LIST_SIZE = 8192
# Longest list whose DCG discount tables fit beside its items
# (kMaxTableListSize); longer lists take the per-pair formula.
MAX_TABLE_LIST_SIZE = 6144
# Blocks a call aims for: four 8-warp blocks for each of the H100's 132
# multiprocessors, all resident at once at 64 registers a thread. A list's
# rows are split over `_tiles(B, L)` blocks.
_TARGET_BLOCKS = 512

_LN2 = 0.6931471805599453

_FORCED: Optional[bool] = None  # None = fused for CUDA tensors only
_PLAIN = False
_lib = None


def set_enabled(value: Optional[bool]) -> None:
  """True forces the fused sums on any device (on the CPU through their
  plain versions, for tests); False disables them, so every pairwise loss
  takes its ``[B, L, L]`` path; None restores the default (fused when the
  logits are a CUDA tensor; a list longer than ``MAX_LIST_SIZE`` then
  raises, and only ``set_enabled(False)`` sends it to the plain path)."""
  global _FORCED
  _FORCED = value


def enabled(logits: Tensor) -> bool:
  if _FORCED is not None:
    return _FORCED
  return logits.device.type == 'cuda'


@contextlib.contextmanager
def plain_versions():
  """Inside, both wrappers compute their plain PyTorch versions, on any
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
    raise ValueError(f'no pairwise kernels for device {x.device}')
  return True


def _kernel():
  global _lib
  if _lib is None:
    lib = build.load_library('pairwise')
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.pairwise_sums_forward.argtypes = [
        p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, f, f, f, p]
    lib.pairwise_sums_backward.argtypes = [
        p, p, p, p, p, p, p, p, i, p, i, i, i, i, i, i, f, f, f, p]
    for fn in (lib.pairwise_sums_forward, lib.pairwise_sums_backward):
      fn.restype = i
    for fn in (lib.pairwise_max_list_size, lib.pairwise_max_table_list_size):
      fn.argtypes, fn.restype = [], i
    if (lib.pairwise_max_list_size() != MAX_LIST_SIZE or
        lib.pairwise_max_table_list_size() != MAX_TABLE_LIST_SIZE):
      raise RuntimeError('csrc/pairwise.cu and pairwise.py disagree on the '
                         'list size domain')
    _lib = lib
  return _lib


def build_kernels() -> None:
  """Compiles and loads the kernel library (otherwise done at first use)."""
  _kernel()


# ---------------------------------------------------------------------------
# The plain versions: the pair math on [B, L, L] tensors
# ---------------------------------------------------------------------------


def _discount(kind: int, r: Tensor) -> Tensor:
  if kind == DISCOUNT_LOG2_INVERSE:
    return torch.full_like(r, _LN2) / torch.log1p(r)
  if kind == DISCOUNT_INVERSE:
    return torch.ones_like(r) / r
  if kind == DISCOUNT_LOG1P_INVERSE:
    return torch.ones_like(r) / torch.log1p(r)
  raise ValueError(f'unknown discount kind {kind}')


def _loss_and_grad(loss_type: int, d: Tensor) -> Tuple[Tensor, Tensor]:
  """Pair loss l(d) and dl/dd for d = s_i - s_j."""
  if loss_type == LOSS_LOGISTIC:
    return (torch.clamp(-d, min=0.0) + torch.log1p(torch.exp(-torch.abs(d))),
            -torch.sigmoid(-d))
  if loss_type == LOSS_HINGE:
    # At the hinge point d == 1 autograd splits the tie of a maximum
    # (-0.5): the gradient here never forks from the plain loss's.
    grad = torch.where(d < 1.0, -1.0, torch.where(d == 1.0, -0.5, 0.0))
    return torch.clamp(1.0 - d, min=0.0), grad.to(torch.float32)
  if loss_type == LOSS_SOFT_ZERO_ONE:
    s = torch.sigmoid(-d)
    return s, -s * (1.0 - s)
  raise ValueError(f'unknown loss_type {loss_type}')


def _pair(t: Tensor) -> Tuple[Tensor, Tensor]:
  return t[:, :, None], t[:, None, :]


def _slab(labels, logits, mask, norm_w, gain, ranks, scale, lambda_mode,
          discount_kind, topn, smooth_fraction):
  """Pair weights and logit differences, both ``[B, L, L]``. The factors of
  a weight are multiplied up in the kernel's order, so that one is zero
  here exactly where it is zero there."""
  lab_i, lab_j = _pair(labels)
  log_i, log_j = _pair(logits)
  m_i, m_j = _pair(mask)
  diff = log_i - log_j
  pref = ((lab_i - lab_j) > 0).to(torch.float32)
  pw = pref * (m_i * m_j)
  if lambda_mode == LAMBDA_LABELDIFF:
    pw = pw * torch.abs(lab_i - lab_j)
  elif lambda_mode in (LAMBDA_DCG_V2, LAMBDA_DCG_V2_NEIGHBOR, LAMBDA_DCG_V1):
    g_i, g_j = _pair(gain)
    r_i, r_j = _pair(ranks)
    pair_gain = torch.abs(g_i - g_j)
    rank_diff = torch.abs(r_i - r_j)
    # Selected, never multiplied: D(0) and 1 / (1 - D) can be infinite.
    gap = torch.where(
        rank_diff > 0.0,
        torch.abs(_discount(discount_kind, torch.clamp(rank_diff, min=1e-12))
                  - _discount(discount_kind, rank_diff + 1.0)), 0.0)
    if lambda_mode == LAMBDA_DCG_V1:
      in_topn = (r_i <= topn) | (r_j <= topn)
      u = torch.where(in_topn, gap, 0.0)
      capped = torch.where(ranks > topn, 0.0, _discount(discount_kind, ranks))
      c_i, c_j = _pair(capped)
      v = torch.abs(c_i - c_j)
      pair_disc = (1.0 - smooth_fraction) * u + smooth_fraction * v
      pair_disc = pair_disc * in_topn.to(torch.float32)
    else:
      max_rank = torch.maximum(r_i, r_j)
      mult = torch.where(
          max_rank > topn,
          torch.ones_like(max_rank) / (1.0 - _discount(discount_kind,
                                                       max_rank)), 1.0)
      pair_disc = torch.where(rank_diff > 0.0, gap * mult, 0.0)
      if lambda_mode == LAMBDA_DCG_V2_NEIGHBOR:
        pair_disc = pair_disc * (rank_diff == 1.0).to(torch.float32)
    pw = pw * pair_gain * pair_disc * scale[:, None, None]
  elif lambda_mode != LAMBDA_NONE:
    raise ValueError(f'unknown lambda_mode {lambda_mode}')
  # Left-item weights apply to every pair (i, j).
  pw = pw * norm_w[:, :, None]
  return pw, diff


def pairwise_sums_reference(labels, logits, mask, norm_w, gain, ranks, scale,
                            loss_type, lambda_mode, discount_kind, topn,
                            smooth_fraction) -> Tensor:
  """Plain PyTorch version of ``pairwise_sums_forward``."""
  pw, diff = _slab(labels, logits, mask, norm_w, gain, ranks, scale,
                   lambda_mode, discount_kind, topn, smooth_fraction)
  losses, _ = _loss_and_grad(loss_type, diff)
  nonzero = torch.sum(pw != 0, dim=(1, 2))  # counted in integers
  return torch.stack([torch.sum(losses * pw, dim=(1, 2)),
                      torch.sum(pw, dim=(1, 2)),
                      nonzero.to(torch.float32)], dim=1)


def pairwise_sums_grad_reference(labels, logits, mask, norm_w, gain, ranks,
                                 scale, loss_type, lambda_mode, discount_kind,
                                 topn, smooth_fraction, ct) -> Tensor:
  """Plain PyTorch version of ``pairwise_sums_backward``."""
  pw, diff = _slab(labels, logits, mask, norm_w, gain, ranks, scale,
                   lambda_mode, discount_kind, topn, smooth_fraction)
  _, grad = _loss_and_grad(loss_type, diff)
  wg = pw * grad
  # d loss_sum / d s_i = sum_j wg[i, j] - sum_j wg[j, i].
  return (torch.sum(wg, dim=2) - torch.sum(wg, dim=1)) * ct[:, 0:1]


# ---------------------------------------------------------------------------
# Rows 7 and 8: the wrappers
# ---------------------------------------------------------------------------


def _checked(labels, logits, mask, norm_w, gain, ranks, scale):
  """The seven operands as contiguous float32 tensors on logits' device."""
  if logits.ndim != 2:
    raise ValueError(f'logits: [B, L] expected, got {tuple(logits.shape)}')
  b, l = logits.shape
  if l > MAX_LIST_SIZE:
    raise ValueError(f'list size {l} exceeds the pairwise kernels\' shared '
                     f'memory domain ({MAX_LIST_SIZE})')
  out = []
  for name, t in (('labels', labels), ('logits', logits), ('mask', mask),
                  ('norm_weights', norm_w), ('gain', gain), ('ranks', ranks)):
    if t.shape != (b, l):
      raise ValueError(f'{name}: [{b}, {l}] expected, got {tuple(t.shape)}')
    out.append(t.detach().to(device=logits.device,
                             dtype=torch.float32).contiguous())
  if scale.shape != (b,):
    raise ValueError(f'scale: [{b}] expected, got {tuple(scale.shape)}')
  out.append(scale.detach().to(device=logits.device,
                               dtype=torch.float32).contiguous())
  return out


def _static_args(loss_type, lambda_mode, discount_kind, topn, smooth_fraction):
  return (int(loss_type), int(lambda_mode), int(discount_kind), float(topn),
          float(smooth_fraction), float(1.0 - smooth_fraction))


def _tiles(b: int, l: int) -> int:
  """Blocks that share one list's rows: enough for ``b`` lists to give
  ``_TARGET_BLOCKS`` blocks, at most one for each 32 items, at least 1. A
  block stages its whole list, so fewer, larger tiles pay for staging once
  more rows."""
  return max(1, min(-(-l // 32), _TARGET_BLOCKS // max(b, 1)))


def _check(err: int, what: str) -> None:
  if err != 0:
    raise RuntimeError(f'{what} launch failed: CUDA error {err}')


def pairwise_sums_forward(labels, logits, mask, norm_w, gain, ranks, scale,
                          loss_type, lambda_mode, discount_kind, topn,
                          smooth_fraction) -> Tensor:
  """Per-list ``[B, 3]`` float32: (sum of loss x pair weight, sum of pair
  weights, count of non-zero pair weights) over all ordered pairs.

  The six per-item operands are ``[B, L]`` and ``scale`` is ``[B]``; gain,
  ranks and scale are read in the DCG modes only.
  """
  if not _use_kernel(logits):
    return pairwise_sums_reference(
        labels, logits, mask, norm_w, gain, ranks, scale, loss_type,
        lambda_mode, discount_kind, topn, smooth_fraction)
  ops = _checked(labels, logits, mask, norm_w, gain, ranks, scale)
  b, l = ops[1].shape
  device = ops[1].device
  out = torch.empty((b, 3), dtype=torch.float32, device=device)
  if b == 0 or l == 0:
    return out.zero_()
  tiles = _tiles(b, l)
  partial_f = torch.empty((b * tiles, 2), dtype=torch.float32, device=device)
  partial_n = torch.empty((b * tiles,), dtype=torch.int32, device=device)
  lib = _kernel()
  with torch.cuda.device(device):
    _check(lib.pairwise_sums_forward(
        *(t.data_ptr() for t in ops), partial_f.data_ptr(),
        partial_n.data_ptr(), out.data_ptr(), b, l, tiles,
        *_static_args(loss_type, lambda_mode, discount_kind, topn,
                      smooth_fraction),
        torch.cuda.current_stream(device).cuda_stream),
           'pairwise_sums_forward')
  pairwise_sums_forward.launches += 1
  return out


pairwise_sums_forward.launches = 0


def pairwise_sums_backward(labels, logits, mask, norm_w, gain, ranks, scale,
                           loss_type, lambda_mode, discount_kind, topn,
                           smooth_fraction, ct) -> Tensor:
  """``dlogits [B, L]`` float32 for the cotangent ``ct [B, 3]`` of the sums
  (column 0 is used: the other two sums carry no gradient)."""
  if not _use_kernel(logits):
    return pairwise_sums_grad_reference(
        labels, logits, mask, norm_w, gain, ranks, scale, loss_type,
        lambda_mode, discount_kind, topn, smooth_fraction, ct)
  ops = _checked(labels, logits, mask, norm_w, gain, ranks, scale)
  b, l = ops[1].shape
  device = ops[1].device
  if ct.shape != (b, 3):
    raise ValueError(f'ct: [{b}, 3] expected, got {tuple(ct.shape)}')
  ct = ct.detach().to(device=device, dtype=torch.float32).contiguous()
  dlogits = torch.empty((b, l), dtype=torch.float32, device=device)
  if b == 0 or l == 0:
    return dlogits
  lib = _kernel()
  with torch.cuda.device(device):
    _check(lib.pairwise_sums_backward(
        *(t.data_ptr() for t in ops), ct.data_ptr(), 3, dlogits.data_ptr(),
        b, l, _tiles(b, l),
        *_static_args(loss_type, lambda_mode, discount_kind, topn,
                      smooth_fraction),
        torch.cuda.current_stream(device).cuda_stream),
           'pairwise_sums_backward')
  pairwise_sums_backward.launches += 1
  return dlogits


pairwise_sums_backward.launches = 0

KERNEL_WRAPPERS = (pairwise_sums_forward, pairwise_sums_backward)


def reset_launches() -> None:
  for fn in KERNEL_WRAPPERS:
    fn.launches = 0


class _PairwiseSums(torch.autograd.Function):
  """``(labels, logits, mask, norm_w, gain, ranks, scale, *static) ->
  sums [B, 3]``. Only the logits get a gradient, and only from column 0."""

  @staticmethod
  def forward(ctx, labels, logits, mask, norm_w, gain, ranks, scale, *static):
    ctx.save_for_backward(labels, logits, mask, norm_w, gain, ranks, scale)
    ctx.static = static
    return pairwise_sums_forward(labels, logits, mask, norm_w, gain, ranks,
                                 scale, *static)

  @staticmethod
  def backward(ctx, ct):
    dlogits = None
    if ctx.needs_input_grad[1]:
      dlogits = pairwise_sums_backward(*ctx.saved_tensors, *ctx.static, ct)
    return (None, dlogits) + (None,) * (5 + len(ctx.static))


def fused_pairwise_sums(
    labels: Tensor,
    logits: Tensor,
    mask: Tensor,
    norm_weights: Tensor,
    loss_type: int,
    lambda_mode: int = LAMBDA_NONE,
    gain: Optional[Tensor] = None,
    ranks: Optional[Tensor] = None,
    scale: Optional[Tensor] = None,
    discount_kind: int = DISCOUNT_LOG2_INVERSE,
    topn: float = 1e9,
    smooth_fraction: float = 0.0,
) -> Tensor:
  """Per-list ``[B, 3]`` (loss_sum, weight_sum, nonzero_count),
  differentiable in the logits.

  ``norm_weights`` are the left-item weights ``[B, L]`` (already masked).
  For the dcg modes pass per-item ``gain`` (cleaned labels through the gain
  function), 1-based ``ranks`` and per-list ``scale`` (list size x optional
  1/maxDCG); ``smooth_fraction`` applies to ``dcg_v1`` only.
  """
  logits = logits.to(torch.float32)
  b, l = logits.shape
  f32 = lambda t: t.detach().to(device=logits.device,  # noqa: E731
                                dtype=torch.float32)
  zeros = torch.zeros((b, l), dtype=torch.float32, device=logits.device)
  return _PairwiseSums.apply(
      f32(labels), logits, f32(mask), f32(norm_weights),
      zeros if gain is None else f32(gain),
      zeros if ranks is None else f32(ranks),
      (torch.ones((b,), dtype=torch.float32, device=logits.device)
       if scale is None else f32(scale)),
      int(loss_type), int(lambda_mode), int(discount_kind), float(topn),
      float(smooth_fraction))


# ---------------------------------------------------------------------------
# The dispatcher
# ---------------------------------------------------------------------------


def maybe_fused_pairwise(loss, labels, logits, weights, mask, reduction,
                         generator=None) -> Optional[Tensor]:
  """Fused scalar pairwise loss, or None if this configuration is not
  covered by the kernels.

  Reproduces ``_PairwiseLoss.__call__``: temperature scaling, left-item
  weight normalization, lambda weights (None / LabelDiff / DCGLambdaWeight
  with smooth_fraction / DCGLambdaWeightV2 / YetiDCGLambdaWeight, with the
  named discount functions) and the SUM / MEAN / SUM_OVER_BATCH_SIZE /
  SUM_BY_NONZERO_WEIGHTS reductions.
  """
  from ranking_tpu_torch.ops import lambda_weights as lw
  from ranking_tpu_torch.ops import losses as losses_lib
  from ranking_tpu_torch.ops import sorting
  from ranking_tpu_torch.ops.reductions import Reduction
  from ranking_tpu_torch.utils import fns, list_ops

  logits = torch.as_tensor(logits).to(torch.float32)
  if not enabled(logits):
    return None
  reduction = Reduction(reduction)
  if reduction not in (Reduction.SUM, Reduction.MEAN,
                       Reduction.SUM_BY_NONZERO_WEIGHTS,
                       Reduction.SUM_OVER_BATCH_SIZE):
    return None
  labels = torch.as_tensor(labels, device=logits.device).to(torch.float32)
  if labels.ndim != 2:
    return None

  loss_type = {
      losses_lib.PairwiseLogisticLoss: LOSS_LOGISTIC,
      losses_lib.PairwiseHingeLoss: LOSS_HINGE,
      losses_lib.PairwiseSoftZeroOneLoss: LOSS_SOFT_ZERO_ONE,
  }.get(type(loss))
  if loss_type is None:
    return None

  lamw = loss.lambda_weight
  lambda_mode, gain, ranks, scale = LAMBDA_NONE, None, None, None
  discount_kind, topn, smooth_fraction = DISCOUNT_LOG2_INVERSE, 1e9, 0.0
  label_valid = list_ops.is_label_valid(labels)
  explicit_mask = mask is not None
  if mask is None:
    mask = label_valid
  logits = loss.get_logits(logits)

  dcg_modes = {
      lw.DCGLambdaWeight: LAMBDA_DCG_V1,
      lw.DCGLambdaWeightV2: LAMBDA_DCG_V2,
      lw.YetiDCGLambdaWeight: LAMBDA_DCG_V2_NEIGHBOR,
  }
  if lamw is None:
    pass
  elif type(lamw) is lw.LabelDiffLambdaWeight:
    lambda_mode = LAMBDA_LABELDIFF
  elif type(lamw) in dcg_modes:
    if explicit_mask:
      # The plain path zeroes the lambda pair gains by LABEL validity while
      # the kernels' pair mask is the caller's mask: the same when the mask
      # is label validity (mask=None, the training path), possibly
      # different otherwise.
      return None
    discount_kind = {
        fns.log2_inverse: DISCOUNT_LOG2_INVERSE,
        fns.inverse: DISCOUNT_INVERSE,
        fns.log1p_inverse: DISCOUNT_LOG1P_INVERSE,
    }.get(lamw.rank_discount_fn)
    if discount_kind is None:
      return None
    lambda_mode = dcg_modes[type(lamw)]
    if lambda_mode == LAMBDA_DCG_V1:
      smooth_fraction = float(lamw.smooth_fraction)
    clean = torch.where(label_valid, labels, 0.0)
    gain = lamw.gain_fn(clean)
    ranks = sorting.compute_ranks(logits, mask.to(torch.bool),
                                  generator=generator).to(torch.float32)
    list_size = labels.shape[1]
    scale = torch.full((labels.shape[0],), float(list_size),
                       dtype=torch.float32, device=logits.device)
    if lamw.normalized:
      inv = sorting.inverse_max_dcg(
          clean, gain_fn=lamw.gain_fn,
          rank_discount_fn=lamw.rank_discount_fn, topn=lamw.topn)
      scale = scale * inv[:, 0]
    topn = float(lamw.topn or list_size)
  else:
    return None

  # Left-item weights masked by LABEL validity (normalize_weights of the
  # plain path), not by the caller's mask, which gates the pair mask and
  # the ranks only.
  if weights is None:
    weights = 1.0
  norm_w = torch.where(label_valid, torch.ones_like(labels) * weights, 0.0)

  sums = fused_pairwise_sums(
      labels, logits, mask, norm_w, loss_type, lambda_mode=lambda_mode,
      gain=gain, ranks=ranks, scale=scale, discount_kind=discount_kind,
      topn=topn, smooth_fraction=smooth_fraction)
  num = torch.sum(sums[:, 0])
  if reduction == Reduction.SUM:
    return num
  if reduction == Reduction.SUM_OVER_BATCH_SIZE:
    return num / float(labels.shape[0] * labels.shape[1] ** 2)
  den = torch.sum(sums[:, 1 if reduction == Reduction.MEAN else 2])
  return torch.where(den > 0, num / torch.clamp(den, min=1e-38),
                     torch.zeros_like(num))
