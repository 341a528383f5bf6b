"""Row-sharded embedding tables with an explicit-collective lookup.

The port's copy of ``ranking_tpu/parallel/embedding.py`` (the reference's
ParameterServerStrategy table partitioning,
tensorflow_ranking/python/keras/strategy_utils.py:100-113): the table lives
row-sharded over the mesh's model group, every rank holds ``vocab / M``
rows, and a lookup is a local take and pooling of the rows the rank owns,
with the count of its tokens appended, summed over the group by the
*reduce* role (``parallel/comm.py``). Pooling before the collective makes
its payload one ``[..., D + 1]`` row a bag, not ``[..., T, D]``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ranking_tpu_torch.parallel import comm
from ranking_tpu_torch.parallel import mesh as mesh_lib

Tensor = torch.Tensor


def local_pooled_partial(table_shard: Tensor, ids: Tensor, shard_index: int,
                         rows_per_shard: int) -> Tensor:
  """Partial pooled lookup over one row shard.

  Ids outside ``[shard_index*rows, (shard_index+1)*rows)`` and padding ids
  (< 0) contribute zero; summing the partials over the model group and
  normalizing gives ``models.embeddings.pooled_lookup``. Returns
  ``[..., D+1]``: the pooled partial sum with the count of the tokens this
  shard owns appended, so that the sum over shards counts each token once.
  """
  lo = shard_index * rows_per_shard
  valid = ids >= 0
  mine = valid & (ids >= lo) & (ids < lo + rows_per_shard)
  local_ids = torch.where(mine, ids - lo, 0)
  embeds = F.embedding(local_ids, table_shard)
  embeds = torch.where(mine[..., None], embeds, 0.0)
  summed = torch.sum(embeds, dim=-2)
  counts = torch.sum(mine.to(summed.dtype), dim=-1, keepdim=True)
  return torch.cat([summed, counts], dim=-1)


def _normalize(summed: Tensor, counts: Tensor, combiner: str) -> Tensor:
  if combiner == 'sum':
    return summed
  if combiner == 'mean':
    return summed / torch.clamp(counts, min=1.0)
  if combiner == 'sqrtn':
    return summed / torch.sqrt(torch.clamp(counts, min=1.0))
  raise ValueError(f'Unknown combiner {combiner!r}')


def sharded_pooled_lookup(table: Tensor, ids: Tensor, mesh: mesh_lib.Mesh,
                          combiner: str = 'mean') -> Tensor:
  """Explicit-collective pooled lookup on a row-sharded table.

  Args:
    table: this rank's row shard ``[rows, dim]`` of a table of ``rows * M``
      rows (M = ``mesh.model``), the rank's shard ``model_index``; on a
      model axis of one, the whole table.
    ids: integer ids ``[..., T]`` of this rank's batch rows (the same on
      every rank of the model group); ids < 0 are padding. Ids at or past
      the table's rows clamp to its last row and still count, as
      ``pooled_lookup``'s do (the JAX function clamps to the last row of
      the table it is given, the padded one where the caller pre-pads).
    mesh: the mesh.
    combiner: 'mean' | 'sum' | 'sqrtn'.

  Returns:
    ``[..., dim]`` pooled embeddings, the same on every rank of the group.
  """
  if combiner not in ('mean', 'sum', 'sqrtn'):
    raise ValueError(f'Unknown combiner {combiner!r}')
  rows = table.shape[0]
  vocab = rows * mesh.model
  ids = torch.where(ids >= 0, torch.clamp(ids, max=vocab - 1), ids)
  partial = local_pooled_partial(table, ids, mesh.model_index, rows)
  out = comm.reduce(partial, mesh.model_group)
  return _normalize(out[..., :-1], out[..., -1:], combiner)


def padded_vocab(vocab_size: int, n_model: int) -> int:
  """``vocab + (-vocab) % n_model``: the stored table's rows."""
  return vocab_size + (-vocab_size) % n_model


class ShardedEmbeddingEncoder(nn.Module):
  """Row-sharded table ``embedding`` and the explicit-collective pooled
  lookup (the JAX package's module of the same name).

  The table is drawn whole, ``normal(0, 1e-2)`` over the padded shape
  ``[vocab + (-vocab) % M, dim]`` from ``generator`` (the JAX module's
  shape; where M divides the vocabulary these are ``EmbeddingEncoder``'s
  draws), and the rank keeps its rows: a model is the same on every mesh.
  A checkpoint stores the padded table, so a vocabulary that the model
  axis does not divide gives tables of other shapes on other meshes
  (ranking_tpu/parallel/embedding.py:128-140): round the vocabulary to a
  multiple of the largest model axis, or serve from an export.

  The sparse train step reads the rows of a gathered slab instead
  (``read_from_slabs``), as it does an ``EmbeddingEncoder``'s.
  """

  def __init__(self, vocab_size: int, embedding_dim: int,
               mesh: mesh_lib.Mesh, combiner: str = 'mean',
               generator: Optional[torch.Generator] = None):
    super().__init__()
    self.vocab_size = vocab_size
    self.combiner = combiner
    rows = padded_vocab(vocab_size, mesh.model)
    whole = torch.empty(rows, embedding_dim)
    with torch.no_grad():
      nn.init.normal_(whole, std=1e-2,
                      generator=torch.Generator() if generator is None
                      else generator)
    self.embedding = nn.Parameter(
        mesh_lib.local_slice(whole, 0, mesh).clone())
    mesh_lib.mark_sharded(self, 'embedding', 0, mesh)
    self.slab: Optional[Tensor] = None

  @property
  def mesh(self) -> mesh_lib.Mesh:
    return self.__dict__['mesh']

  def forward(self, ids: Tensor) -> Tensor:
    if self.slab is not None:
      from ranking_tpu_torch.models.embeddings import pooled_lookup
      return pooled_lookup(self.slab, ids, self.combiner)
    return sharded_pooled_lookup(self.embedding, ids, self.mesh,
                                 self.combiner)
