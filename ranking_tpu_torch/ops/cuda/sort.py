"""Per-list sort: ranks and sorted value channels in one kernel launch.

Hopper counterpart of the Pallas TPU kernel in
``ranking_tpu/ops/pallas/sort.py`` (``sorted_values_and_ranks``, kernel
``_rank_kernel``). The CUDA C++ kernel is ``csrc/sort.cu``; its header
states the function, the design and the bound. Tie and mask semantics are
deterministic: invalid items always lose to valid ones, and equal scores
keep their original order (stable descending).

``sorted_values_and_ranks`` launches the kernel for tensors on a CUDA
device and computes ``sorted_values_and_ranks_reference``, the plain
PyTorch version, for tensors on the CPU. A CUDA call that the kernel cannot
take raises; it never falls back to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from ranking_tpu_torch.ops.cuda import build

# Items of one list the kernel holds in shared memory (csrc/sort.cu).
MAX_LIST_SIZE = 32768

_lib = None


def _kernel():
  global _lib
  if _lib is None:
    lib = build.load_library('sort')
    lib.rank_sort_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.rank_sort_f32.restype = ctypes.c_int
    lib.rank_sort_max_list_size.argtypes = []
    lib.rank_sort_max_list_size.restype = ctypes.c_int
    if lib.rank_sort_max_list_size() != MAX_LIST_SIZE:
      raise RuntimeError('csrc/sort.cu and sort.py disagree on the list '
                         'size domain')
    _lib = lib
  return _lib


def _ordered_keys(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
  """int64 keys whose descending order is (score desc, valid first).

  A float32's bits, with the low 31 bits flipped for negative values, order
  like the floats themselves; -0.0 is folded into +0.0 first, as the
  kernel's keys fold it (csrc/sort.cu builds the same order from the same
  bits, with the position's complement below the validity bit).
  """
  scores = torch.where(scores == 0, torch.zeros_like(scores), scores)
  bits = scores.contiguous().view(torch.int32).to(torch.int64)
  ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
  return ordered * 2 + valid.to(torch.int64)


def sort_order(scores: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
  """``[B, L]`` int64 permutation of each list in the kernel's order.

  Invalid scores take the row's valid minimum (0.0 for a row with no valid
  item) and lose ties to valid items; remaining ties keep their position,
  through a stable sort on a composite key.
  """
  scores = scores.to(torch.float32)
  valid = (torch.ones_like(scores, dtype=torch.bool) if mask is None
           else mask.to(torch.bool) if mask.dtype == torch.bool
           else mask > 0)
  inf = torch.full_like(scores, float('inf'))
  row_min = torch.amin(torch.where(valid, scores, inf), dim=1, keepdim=True)
  row_min = torch.where(row_min == float('inf'), torch.zeros_like(row_min),
                        row_min)
  filled = torch.where(valid, scores, row_min)
  keys = _ordered_keys(filled, valid)
  return torch.sort(keys, dim=1, descending=True, stable=True).indices


def sorted_values_and_ranks_reference(
    scores: torch.Tensor,
    values: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    topn: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
  """Plain PyTorch version of the kernel: a stable sort, then a gather."""
  b, l = scores.shape
  topn = l if topn is None else min(topn, l)
  order = sort_order(scores, mask)
  ranks = torch.empty((b, l), dtype=torch.float32, device=scores.device)
  positions = torch.arange(1, l + 1, dtype=torch.float32,
                           device=scores.device).expand(b, l)
  ranks.scatter_(1, order, positions)
  values = values.to(torch.float32)
  idx = order[:, :topn, None].expand(b, topn, values.shape[-1])
  return torch.gather(values, 1, idx), ranks


def sorted_values_and_ranks(
    scores: torch.Tensor,
    values: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    topn: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
  """Ranks and sorted value channels for every list.

  Args:
    scores: ``[B, L]``.
    values: ``[B, L, K]`` channels to reorder by descending score.
    mask: ``[B, L]`` validity (bool, or numbers > 0); invalid items sort
      last.
    topn: output length (default L).

  Returns:
    (sorted ``[B, topn, K]`` float32, ranks ``[B, L]`` float32 1-based).
  """
  if scores.device.type == 'cpu':
    return sorted_values_and_ranks_reference(scores, values, mask, topn)
  if scores.device.type != 'cuda':
    raise ValueError(f'no sort kernel for device {scores.device}')
  if scores.ndim != 2 or values.ndim != 3 or values.shape[:2] != scores.shape:
    raise ValueError(f'scores [B, L] and values [B, L, K] expected, got '
                     f'{tuple(scores.shape)} and {tuple(values.shape)}')
  b, l = scores.shape
  k = values.shape[-1]
  topn = l if topn is None else min(topn, l)
  if l > MAX_LIST_SIZE:
    raise ValueError(f'list size {l} exceeds the sort kernel\'s shared '
                     f'memory domain ({MAX_LIST_SIZE})')
  if topn < 1 or k < 1:
    raise ValueError(f'topn and channel count must be >= 1 (topn={topn}, '
                     f'K={k})')
  device = scores.device
  scores = scores.to(torch.float32).contiguous()
  values = values.to(device=device, dtype=torch.float32).contiguous()
  if mask is not None:
    mask = (mask if mask.dtype == torch.bool else mask > 0)
    mask = mask.to(device).contiguous()
    if mask.shape != scores.shape:
      raise ValueError(f'mask {tuple(mask.shape)} != scores '
                       f'{tuple(scores.shape)}')
  ranks = torch.empty((b, l), dtype=torch.float32, device=device)
  out = torch.empty((b, topn, k), dtype=torch.float32, device=device)
  if b == 0:
    return out, ranks
  lib = _kernel()
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.rank_sort_f32(
        scores.data_ptr(), None if mask is None else mask.data_ptr(),
        values.data_ptr(), ranks.data_ptr(), out.data_ptr(), b, l, k, topn,
        stream)
  if err != 0:
    raise RuntimeError(f'rank_sort_f32 launch failed: CUDA error {err}')
  sorted_values_and_ranks.launches += 1
  return out, ranks


sorted_values_and_ranks.launches = 0


def sort_by_scores(
    scores: torch.Tensor,
    features_list: Sequence[torch.Tensor],
    topn: Optional[int] = None,
    mask: Optional[torch.Tensor] = None,
) -> List[torch.Tensor]:
  """Sorts 2-D feature tensors per list, all channels in one launch."""
  stacked = torch.stack([f.to(torch.float32) for f in features_list], dim=-1)
  out, _ = sorted_values_and_ranks(scores, stacked, mask=mask, topn=topn)
  return [out[..., i] for i in range(len(features_list))]
