"""List-axis sharding: pairwise losses over lists too long for one card.

The port's copy of ``ranking_tpu/parallel/list_sharding.py``. The list axis
itself is split over a mesh axis: each rank owns ``L/n`` documents of every
list, computes its ``[B, L/n, L]`` slab of the pair matrix against the
column entities gathered from the group (the *gather* role, whose backward
sums each column's gradient over the slabs), and the per-list reduction
terms are summed by the *reduce* role (``parallel/comm.py``). Memory a rank
is O(B·L²/n); the collective payload is O(B·L), never O(B·L²).

The arithmetic is the JAX function's, which is jnp and not the Pallas
kernel: its logistic loss ``max(-d, 0) + log1p(exp(-|d|))`` has the
gradient -1 at a tie (the kernel's -0.5), by ``jnp.maximum``'s even split
and ``jnp.abs``'s derivative 1 at 0, which ``ops.losses`` mirrors.
"""

from __future__ import annotations

from typing import Optional

import torch

from ranking_tpu_torch.ops import losses as losses_lib
from ranking_tpu_torch.ops.reductions import Reduction
from ranking_tpu_torch.parallel import comm
from ranking_tpu_torch.parallel import mesh as mesh_lib

Tensor = torch.Tensor


def _pair_loss(kind: str, d: Tensor) -> Tensor:
  if kind == 'logistic':
    return (losses_lib._maximum0(-d)
            + torch.log1p(torch.exp(-losses_lib._abs(d))))
  if kind == 'hinge':
    return losses_lib._maximum0(1.0 - d)
  if kind == 'soft_zero_one':
    return torch.sigmoid(-d)
  raise ValueError(f'unknown pair loss {kind!r}')


def sharded_pairwise_loss(
    labels: Tensor,
    logits: Tensor,
    mesh: mesh_lib.Mesh,
    axis: str = mesh_lib.MODEL_AXIS,
    loss_kind: str = 'logistic',
    weights: Optional[Tensor] = None,
    reduction: Reduction = Reduction.SUM_BY_NONZERO_WEIGHTS,
    data_axis: Optional[str] = None,
) -> Tensor:
  """Pairwise loss with the list axis split over ``mesh``'s ``axis``.

  Args:
    labels, logits: this rank's block ``[B', L/n]``: list columns
      ``[i·L/n, (i+1)·L/n)`` for its index i on ``axis`` (n its size), and
      with ``data_axis`` its rows of the batch (else every row); padding
      label -1.
    mesh: the mesh.
    axis: the mesh axis the list is split over.
    loss_kind: 'logistic' | 'hinge' | 'soft_zero_one'.
    weights: optional per-item (left-hand) weights of the same block.
    reduction: SUM / MEAN / SUM_BY_NONZERO_WEIGHTS.
    data_axis: if set, the batch is split over this axis too, and the
      reduction sums over both.

  Returns:
    the scalar loss of the whole batch, the same on every rank; its
    gradient flows to this rank's block of ``logits``.
  """
  reduction = Reduction(reduction)
  if reduction not in (Reduction.SUM, Reduction.MEAN,
                       Reduction.SUM_BY_NONZERO_WEIGHTS):
    raise ValueError(f'unsupported reduction {reduction}')
  if data_axis is not None and data_axis == axis:
    raise ValueError('data_axis must differ from axis')
  lab_s = labels.to(torch.float32)
  log_s = logits.to(torch.float32)
  w_s = (torch.ones_like(lab_s) if weights is None
         else torch.broadcast_to(weights.to(torch.float32), lab_s.shape))
  group = mesh.group(axis)
  reduce_groups = [group] + ([] if data_axis is None
                             else [mesh.group(data_axis)])
  # Column entities: the whole list, gathered along the split axis.
  lab = comm.all_gather(lab_s, group, 1)
  log = comm.gather(log_s, group, 1)
  valid_rows = lab_s >= 0
  valid_cols = lab >= 0
  diff = log_s[:, :, None] - log[:, None, :]
  pref = ((lab_s[:, :, None] - lab[:, None, :]) > 0).to(torch.float32)
  pair_valid = valid_rows[:, :, None] & valid_cols[:, None, :]
  w_rows = torch.where(valid_rows, w_s, 0.0)
  pw = pref * pair_valid.to(torch.float32) * w_rows[:, :, None]
  num = torch.sum(_pair_loss(loss_kind, diff) * pw)
  for g in reduce_groups:
    num = comm.reduce(num, g)
  if reduction == Reduction.SUM:
    return num
  if reduction == Reduction.MEAN:
    den = torch.sum(pw)
  else:
    den = torch.sum((pw != 0).to(torch.float32))
  for g in reduce_groups:
    den = comm.reduce(den.detach(), g)
  return torch.where(den > 0, num / torch.clamp(den, min=1e-38),
                     torch.zeros_like(num))
