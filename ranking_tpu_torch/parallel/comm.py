"""Collectives with their gradients, and the mesh of the step in progress.

The JAX package writes none of this: XLA inserts the collectives of an SPMD
program and differentiates through them. Here they are small
``torch.autograd.Function``s, one for each role a collective plays
(Megatron's naming):

* ``reduce``: forward all-reduce (sum), backward identity. Its consumers are
  replicated over the group (every rank computes the same thing from the
  sum), so each rank's gradient of the sum is already the whole one.
  Sharded lookups and row-parallel products end in it.
* ``copy``: forward identity, backward all-reduce. A replicated input
  entering sharded consumers (column-parallel products).
* ``gather``: forward all-gather, backward reduce-scatter. Every rank's
  consumers differ (the list-sharded pairwise loss's slabs), so the
  gradient of each slice is the sum of every rank's.
* ``gather_replicated``: forward all-gather, backward this rank's slice of
  the gradient. The consumers are replicated (the loss, computed whole on
  every rank from the gathered logits), so every rank's gradient of the
  gathered tensor is the same and the own slice is the whole answer.
* ``sum_over``: forward all-reduce, backward all-reduce. Batch statistics
  over the data group: each rank's rows reach the loss through the global
  sum, so the sum's gradient is the sum of every rank's.

(``torch.distributed.nn.functional.all_reduce`` is ``sum_over``. Used where
``reduce`` belongs, it would scale every gradient by the group's size.)

Each function takes a process group, and is the identity where the group is
None (a mesh of one with no process group). Gloo does not take CUDA tensors
for most collectives; there the tensor goes through host memory. No
collective is skipped on an error.

``active(mesh)`` sets the mesh of the data-parallel step in progress (as
``list_ops.shared_sort_scope`` sets a step's shared sorts): the layers read
it to take batch statistics over the data group (``row_means``) and to draw
the global batch's dropout masks (``draw_rows``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, List, Sequence

import torch

Tensor = torch.Tensor

_ACTIVE = None  # the Mesh of the step in progress


@contextlib.contextmanager
def active(mesh) -> Iterator[None]:
  """Inside, the data-parallel step of ``mesh`` is in progress (None: no
  data parallelism)."""
  global _ACTIVE
  prev, _ACTIVE = _ACTIVE, mesh
  try:
    yield
  finally:
    _ACTIVE = prev


def data_group():
  """The data group of the step in progress, or None."""
  mesh = _ACTIVE
  return None if mesh is None else mesh.data_group


def _dist():
  import torch.distributed as dist
  return dist


def _via_host(t: Tensor, group) -> bool:
  return t.is_cuda and _dist().get_backend(group) == 'gloo'


def _size(group) -> int:
  return _dist().get_world_size(group)


def _rank(group) -> int:
  return _dist().get_rank(group)


def all_reduce(t: Tensor, group, op: str = 'sum') -> Tensor:
  """A new tensor: ``t`` summed (or its minimum, maximum) over ``group``."""
  if group is None:
    return t
  dist = _dist()
  red = {'sum': dist.ReduceOp.SUM, 'min': dist.ReduceOp.MIN,
         'max': dist.ReduceOp.MAX}[op]
  if _via_host(t, group):
    out = t.detach().to('cpu', copy=True)
    dist.all_reduce(out, red, group=group)
    return out.to(t.device)
  out = t.detach().clone(memory_format=torch.contiguous_format)
  dist.all_reduce(out, red, group=group)
  return out


def all_gather(t: Tensor, group, dim: int = 0) -> Tensor:
  """Every rank's ``t`` concatenated along ``dim`` in rank order."""
  if group is None:
    return t
  dist = _dist()
  src = t.detach().contiguous()
  host = _via_host(src, group)
  if host:
    src = src.cpu()
  parts = [torch.empty_like(src) for _ in range(_size(group))]
  dist.all_gather(parts, src, group=group)
  out = torch.cat(parts, dim=dim)
  return out.to(t.device) if host else out


def _own(t: Tensor, group, dim: int) -> Tensor:
  n = _size(group)
  size = t.shape[dim] // n
  return t.narrow(dim, _rank(group) * size, size)


class _Reduce(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, group):
    return all_reduce(x, group)

  @staticmethod
  def backward(ctx, g):
    return g, None


class _Copy(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, group):
    ctx.group = group
    return x.view_as(x)

  @staticmethod
  def backward(ctx, g):
    return all_reduce(g, ctx.group), None


class _SumOver(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, group):
    ctx.group = group
    return all_reduce(x, group)

  @staticmethod
  def backward(ctx, g):
    return all_reduce(g, ctx.group), None


class _Gather(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, group, dim):
    ctx.group, ctx.dim = group, dim
    return all_gather(x, group, dim)

  @staticmethod
  def backward(ctx, g):
    # Reduce-scatter as an all-reduce and the own slice: gloo has no
    # reduce-scatter, and the slices are small (O(L) a list).
    return _own(all_reduce(g, ctx.group), ctx.group, ctx.dim), None, None


class _GatherReplicated(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, group, dim):
    ctx.group, ctx.dim = group, dim
    return all_gather(x, group, dim)

  @staticmethod
  def backward(ctx, g):
    return _own(g, ctx.group, ctx.dim).contiguous(), None, None


def reduce(x: Tensor, group) -> Tensor:
  """Forward all-reduce (sum), backward identity."""
  return x if group is None else _Reduce.apply(x, group)


def copy(x: Tensor, group) -> Tensor:
  """Forward identity, backward all-reduce."""
  return x if group is None else _Copy.apply(x, group)


def sum_over(x: Tensor, group) -> Tensor:
  """Forward all-reduce, backward all-reduce."""
  return x if group is None else _SumOver.apply(x, group)


def gather(x: Tensor, group, dim: int = 0) -> Tensor:
  """Forward all-gather along ``dim``, backward reduce-scatter."""
  return x if group is None else _Gather.apply(x, group, dim)


def gather_replicated(x: Tensor, group, dim: int = 0) -> Tensor:
  """Forward all-gather along ``dim``, backward the own slice."""
  return x if group is None else _GatherReplicated.apply(x, group, dim)


def all_reduce_grads(params: Sequence[torch.nn.Parameter], group) -> None:
  """Sums every parameter's gradient over ``group``, in place, as one
  flat buffer (the data group's gradient all-reduce)."""
  if group is None:
    return
  grads = [p.grad for p in params if p.grad is not None]
  if not grads:
    return
  flat = torch.cat([g.reshape(-1) for g in grads])
  flat = all_reduce(flat, group)
  offset = 0
  for g in grads:
    g.copy_(flat[offset:offset + g.numel()].view_as(g))
    offset += g.numel()


def draw_rows(draw: Callable[[tuple], Tensor], shape: Sequence[int],
              dim: int = 0) -> Tensor:
  """``draw(shape)``; where a data-parallel step is in progress, this
  rank's rows of ``draw`` over the global batch's rows: every rank draws
  the global batch's numbers from the shared generator, so that a run's
  result does not depend on the mesh. ``shape[dim]`` is the rank's rows, a
  contiguous block of the global ones."""
  mesh = _ACTIVE
  shape = tuple(shape)
  if mesh is None or mesh.data == 1:
    return draw(shape)
  n = shape[dim]
  whole = draw(shape[:dim] + (n * mesh.data,) + shape[dim + 1:])
  return whole.narrow(dim, mesh.data_index * n, n)


def row_means(xs: Sequence[Tensor], dim: int = 0) -> List[Tensor]:
  """Each tensor's mean over ``dim``: over the global batch's rows where a
  data-parallel step is in progress (the sums in one ``sum_over``, whose
  gradient reaches every rank's rows, over the global row count), else
  over its own rows (``Tensor.mean``)."""
  group = data_group()
  if group is None:
    return [x.mean(dim) for x in xs]
  sums = sum_over(torch.stack([torch.sum(x, dim=dim) for x in xs]), group)
  return list((sums / (xs[0].shape[dim] * _ACTIVE.data)).unbind(0))
