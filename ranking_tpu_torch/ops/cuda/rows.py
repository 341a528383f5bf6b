"""In-place row scatter into embedding tables for Hopper.

Counterpart of ``ranking_tpu/ops/pallas/rows.py`` (``scatter_rows`` and
``scatter_rows_multi``). The sparse train step writes the rows it touched
(parameters and optimizer moments) back with these: ``table[ids[i]] =
updates[i]`` for every slot with ``valid[i] != 0`` and ``0 <= ids[i] < V``,
in place, for n tables of one shape under one id stream. The CUDA C++
kernel is ``csrc/rows.cu``; its header states the function, the design and
the bound. Valid ids must be unique, which the step's deduplication
guarantees.

Each wrapper launches the kernel for CUDA tensors and computes its plain
PyTorch version (``scatter_rows_reference``, ``scatter_rows_multi_reference``)
for CPU tensors, and counts its launches in ``.launches``. A CUDA call that
the kernel cannot take raises; nothing falls back to the plain version on
the card. ``plain_versions()`` forces the plain versions on any device, for
holding the kernel against them. The TPU kernel's limits (row width 128, a
block of 256 rows) are Mosaic's and do not apply: any width, any K.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional, Sequence, Tuple

import torch

from ranking_tpu_torch.ops.cuda import build

Tensor = torch.Tensor

# Tables one launch writes (csrc/rows.cu: kMaxTables).
MAX_TABLES = 3

_ENABLED = True
_PLAIN = False
_lib = None


def set_enabled(value: Optional[bool]) -> None:
  """False sends every row write of the sparse step to the plain version,
  on any device; True or None (the default) lets the wrappers run, which
  launch the kernel for CUDA tables."""
  global _ENABLED
  _ENABLED = value is not False


def enabled() -> bool:
  return _ENABLED


@contextlib.contextmanager
def plain_versions():
  """Inside, both wrappers compute their plain PyTorch versions, on any
  device. For comparing the kernel with them; the port never uses it."""
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
    raise ValueError(f'no row scatter kernel for device {x.device}')
  return True


def _kernel():
  global _lib
  if _lib is None:
    lib = build.load_library('rows')
    p = ctypes.c_void_p
    lib.scatter_rows.argtypes = [p, p, p, p, p, p, p, ctypes.c_int, p,
                                 ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int, ctypes.c_int, p]
    lib.scatter_rows.restype = ctypes.c_int
    lib.rows_max_tables.argtypes, lib.rows_max_tables.restype = [], ctypes.c_int
    if lib.rows_max_tables() != MAX_TABLES:
      raise RuntimeError('csrc/rows.cu and rows.py disagree on the number '
                         'of tables a launch writes')
    _lib = lib
  return _lib


def build_kernels() -> None:
  """Compiles and loads the kernel library (otherwise done at first use)."""
  _kernel()


# ---------------------------------------------------------------------------
# The plain versions
# ---------------------------------------------------------------------------


def scatter_rows_reference(table: Tensor, ids: Tensor, valid: Tensor,
                           updates: Tensor) -> Tensor:
  """Plain version, in place: drops invalid slots and ids outside
  ``[0, V)`` (no negative-index wrapping: the kernel writes raw addresses
  and has no such notion), then ``index_copy_`` of the rest. Picking the
  kept slots synchronises with the host; it never runs on the card's main
  path."""
  ok = (valid != 0) & (ids >= 0) & (ids < table.shape[0])
  kept = torch.nonzero(ok).squeeze(1)
  table.index_copy_(0, ids[kept].to(torch.int64),
                    updates[kept].to(table.dtype))
  return table


def scatter_rows_multi_reference(tables: Sequence[Tensor], ids: Tensor,
                                 valid: Tensor,
                                 updates: Sequence[Tensor]) -> Tuple[Tensor, ...]:
  """Plain version of ``scatter_rows_multi``: each table on its own."""
  return tuple(scatter_rows_reference(t, ids, valid, u)
               for t, u in zip(tables, updates))


# ---------------------------------------------------------------------------
# Rows 9 and 10: the wrappers
# ---------------------------------------------------------------------------


def _launch(tables, ids, valid, updates) -> None:
  """Checks what the kernel takes and launches it for ``len(tables)``
  tables of one shape and dtype."""
  table = tables[0]
  device = table.device
  if table.ndim != 2:
    raise ValueError(f'scatter_rows: tables must be [V, D], got '
                     f'{tuple(table.shape)}')
  if table.element_size() not in (2, 4):
    raise ValueError(f'scatter_rows: no kernel for {table.dtype} (2- and '
                     '4-byte elements only)')
  v, d = table.shape
  k = ids.shape[0]
  for t, u in zip(tables, updates):
    if t.device != device or u.device != device:
      raise ValueError('scatter_rows: tables and updates must share a device')
    if not t.is_contiguous():
      raise ValueError('scatter_rows: tables must be contiguous (the kernel '
                       'writes into their storage)')
    if u.dtype != t.dtype or tuple(u.shape) != (k, d):
      raise ValueError(f'scatter_rows: updates must be [{k}, {d}] '
                       f'{t.dtype}, got {tuple(u.shape)} {u.dtype}')
  if ids.is_floating_point() or ids.is_complex() or ids.dtype == torch.bool:
    raise ValueError(f'scatter_rows: ids must be integers, got {ids.dtype}')
  updates = [u.contiguous() for u in updates]
  # int32 and int64 ids go to the kernel as they are, which compares them
  # with V in 64 bits: a narrowing cast here would wrap an id >= 2^31 into
  # the table.
  if ids.dtype not in (torch.int32, torch.int64):
    ids = ids.to(torch.int64)
  ids = ids.to(device).contiguous()
  valid = (valid != 0).to(device).contiguous()
  n = len(tables)
  ptrs = [t.data_ptr() for t in tables] + [None] * (MAX_TABLES - n)
  uptrs = [u.data_ptr() for u in updates] + [None] * (MAX_TABLES - n)
  lib = _kernel()
  with torch.cuda.device(device):
    err = lib.scatter_rows(*ptrs, *uptrs, ids.data_ptr(), ids.element_size(),
                           valid.data_ptr(), n, k, v, d, table.element_size(),
                           torch.cuda.current_stream(device).cuda_stream)
  if err != 0:
    raise RuntimeError(f'scatter_rows launch failed: CUDA error {err}')
  # Autograd sees a write through a raw pointer only if it is told.
  for t in tables:
    torch.autograd.graph.increment_version(t)


def scatter_rows(table: Tensor, ids: Tensor, valid: Tensor,
                 updates: Tensor) -> Tensor:
  """In-place row scatter: ``table[ids[i]] = updates[i]`` where valid.

  Args:
    table: ``[V, D]`` table, written in place.
    ids: ``[K]`` integer row ids, unique among valid slots; ids outside
      ``[0, V)`` are dropped.
    valid: ``[K]`` bool or integer; zero slots are skipped.
    updates: ``[K, D]`` rows, of the table's dtype on the card.

  Returns:
    ``table``.
  """
  if not _use_kernel(table):
    return scatter_rows_reference(table, ids, valid, updates)
  if ids.shape != (updates.shape[0],) or valid.shape != ids.shape:
    raise ValueError(f'scatter_rows: ids/valid must be shape '
                     f'({updates.shape[0]},), got ids {tuple(ids.shape)}, '
                     f'valid {tuple(valid.shape)}')
  _launch([table], ids, valid, [updates])
  scatter_rows.launches += 1
  return table


scatter_rows.launches = 0


def scatter_rows_multi(tables: Sequence[Tensor], ids: Tensor, valid: Tensor,
                       updates: Sequence[Tensor]) -> Tuple[Tensor, ...]:
  """In-place row scatter of ``n`` update slabs into ``n`` tables of one
  shape and dtype under one id stream: LazyAdagrad writes (param,
  accumulator) and LazyAdam (param, m, v) rows at the same ids. One launch
  writes all ``n``; per table the function is ``scatter_rows``'s. ``n == 1``
  is ``scatter_rows``. Returns the tables."""
  tables = list(tables)
  updates = list(updates)
  n = len(tables)
  if n != len(updates) or n == 0:
    raise ValueError('scatter_rows_multi: need equally many tables and '
                     f'update slabs, got {n} vs {len(updates)}')
  shape, dtype = tables[0].shape, tables[0].dtype
  if any(t.shape != shape or t.dtype != dtype for t in tables):
    raise ValueError('scatter_rows_multi: tables must share shape/dtype, '
                     f'got {[(tuple(t.shape), t.dtype) for t in tables]}')
  k, d = updates[0].shape
  # The kernel reads ids/valid as a stream sized to the update slabs: a
  # shorter ids array would be read out of bounds.
  if any(tuple(u.shape) != (k, d) for u in updates):
    raise ValueError('scatter_rows_multi: update slabs must share shape '
                     f'({k}, {d}), got {[tuple(u.shape) for u in updates]}')
  if ids.shape != (k,) or valid.shape != (k,):
    raise ValueError(f'scatter_rows_multi: ids/valid must be shape ({k},) '
                     f'matching the update slabs, got ids {tuple(ids.shape)}, '
                     f'valid {tuple(valid.shape)}')
  if n == 1:
    return (scatter_rows(tables[0], ids, valid, updates[0]),)
  if not _use_kernel(tables[0]):
    return scatter_rows_multi_reference(tables, ids, valid, updates)
  if n > MAX_TABLES:
    raise ValueError(f'scatter_rows_multi: the kernel writes at most '
                     f'{MAX_TABLES} tables, got {n}')
  _launch(tables, ids, valid, updates)
  scatter_rows_multi.launches += 1
  return tuple(tables)


scatter_rows_multi.launches = 0

KERNEL_WRAPPERS = (scatter_rows, scatter_rows_multi)


def reset_launches() -> None:
  for fn in KERNEL_WRAPPERS:
    fn.launches = 0
