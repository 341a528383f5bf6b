"""Embedding encoders for sparse token-id features.

The port's copy of ``ranking_tpu/models/embeddings.py``: token-id features
``[B, T]`` (context) or ``[B, L, T]`` (examples) are looked up in a table
and pooled over the token axis; ids below 0 are padding, masked out of the
pooling.

``Embed`` is flax's ``nn.Embed``, the plain lookup with no pooling that the
transformer encoder's tables use (``models/encoder.py``).

The sparse train step (``train/steps.py`` ``make_sparse_train_step``) reads
each encoder's rows, and an ``Embed``'s, from a gathered slab ``[K, dim]``
with batch-local slot ids instead of from its table. The JAX package
redirects the lookup with flax's ``intercept_methods``; here
``read_from_slabs`` sets the slab on the module for the length of the
step's forward. Outside it (eval, serving) a module reads its whole table.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor


def pooled_lookup(table: Tensor, ids: Tensor, combiner: str = 'mean') -> Tensor:
  """Masked pooled embedding lookup.

  Args:
    table: ``[vocab, dim]`` embedding table.
    ids: integer ids, any shape ``[..., T]``; ids < 0 are padding. Ids
      >= vocab clip to the last row and still count toward the combiner.
    combiner: 'mean' | 'sum' | 'sqrtn'.

  Returns:
    ``[..., dim]`` pooled embeddings.
  """
  if combiner not in ('mean', 'sum', 'sqrtn'):
    raise ValueError(f'Unknown combiner {combiner!r}')
  valid = ids >= 0
  safe_ids = torch.clamp(torch.where(valid, ids, 0), max=table.shape[0] - 1)
  embeds = F.embedding(safe_ids, table)
  embeds = torch.where(valid[..., None], embeds, 0.0)
  summed = torch.sum(embeds, dim=-2)
  counts = torch.sum(valid.to(embeds.dtype), dim=-1, keepdim=True)
  if combiner == 'sum':
    return summed
  if combiner == 'mean':
    return summed / torch.clamp(counts, min=1.0)
  return summed / torch.sqrt(torch.clamp(counts, min=1.0))


class EmbeddingEncoder(nn.Module):
  """Learned embedding table ``embedding [vocab, dim]`` with masked pooling
  over a token axis. The table starts normal(0, 1e-2), drawn from
  ``generator``."""

  def __init__(self, vocab_size: int, embedding_dim: int,
               combiner: str = 'mean',
               generator: Optional[torch.Generator] = None):
    super().__init__()
    self.combiner = combiner
    self.embedding = nn.Parameter(torch.empty(vocab_size, embedding_dim))
    # The sparse step's row slab for this encoder (read_from_slabs).
    self.slab: Optional[Tensor] = None
    with torch.no_grad():
      nn.init.normal_(self.embedding, std=1e-2,
                      generator=torch.Generator() if generator is None
                      else generator)

  def _ids(self, ids: Tensor) -> Tensor:
    return ids

  def forward(self, ids: Tensor) -> Tensor:
    if self.slab is not None:
      # Slot ids, already reduced by the step; padding stays negative.
      return pooled_lookup(self.slab, ids, self.combiner)
    if 'embedding' in self.__dict__.get('model_shards', ()):
      # A row shard (parallel.mesh.shard_module): the sharded lookup.
      from ranking_tpu_torch.parallel import embedding as sharded
      return sharded.sharded_pooled_lookup(
          self.embedding, self._ids(ids), self.__dict__['mesh'],
          self.combiner)
    return pooled_lookup(self.embedding, self._ids(ids), self.combiner)


class HashEmbeddingEncoder(EmbeddingEncoder):
  """Embedding over hashed ids (vocabulary-free): ids are reduced modulo
  ``num_buckets`` before the lookup, as
  ``categorical_column_with_hash_bucket`` + embedding."""

  def __init__(self, num_buckets: int, embedding_dim: int,
               combiner: str = 'mean',
               generator: Optional[torch.Generator] = None):
    super().__init__(num_buckets, embedding_dim, combiner, generator)
    self.num_buckets = num_buckets

  def _ids(self, ids: Tensor) -> Tensor:
    return torch.where(ids >= 0, torch.remainder(ids, self.num_buckets), -1)


# Tables of at most this many rows are read by selecting rows, not by a
# gather: the card's embedding backward adds a row's long runs of equal ids
# (a segment table's 2 rows under 8,192 tokens) in an order that varies
# from run to run, where the selection's backward is a sum over the batch
# in one fixed order.
_SELECT_ROWS = 8


def take(table: Tensor, ids: Tensor) -> Tensor:
  """``jnp.take(table, ids, axis=0)`` in its default mode: ids in [-n, 0)
  count from the end, ids outside [-n, n) read NaN rows (its fill)."""
  n = table.shape[0]
  ids = torch.where(ids < 0, ids + n, ids)
  valid = (ids >= 0) & (ids < n)
  if n <= _SELECT_ROWS:
    rows = table[0].expand(tuple(ids.shape) + tuple(table.shape[1:]))
    for j in range(1, n):
      rows = torch.where((ids == j)[..., None], table[j], rows)
  else:
    rows = F.embedding(torch.clamp(ids, 0, n - 1), table)
  return torch.where(valid[..., None], rows, math.nan)


class Embed(nn.Module):
  """flax's ``nn.Embed``: a table ``embedding [num_embeddings, features]``
  read by integer ids ``[...]`` -> ``[..., features]`` in ``dtype`` (the
  rows cast after the gather, which gives the bits of flax's cast table).
  A table of one row broadcasts it whatever the ids, as flax's does. The
  table starts normal(0, 1 / features), flax's default initializer."""

  def __init__(self, num_embeddings: int, features: int,
               generator: Optional[torch.Generator] = None,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    self.dtype = dtype
    self.embedding = nn.Parameter(torch.empty(num_embeddings, features))
    # The sparse step's row slab (read_from_slabs).
    self.slab: Optional[Tensor] = None
    with torch.no_grad():
      nn.init.normal_(self.embedding, std=features ** -0.5,
                      generator=torch.Generator() if generator is None
                      else generator)

  def table(self) -> Tensor:
    """The whole table: where it is row-sharded over the model group
    (``parallel.mesh.shard_module``), the shards gathered (every rank of
    the group then computes the same lookups, so each keeps its own rows'
    gradient)."""
    if 'embedding' not in self.__dict__.get('model_shards', ()):
      return self.embedding
    from ranking_tpu_torch.parallel import comm
    return comm.gather_replicated(self.embedding,
                                  self.__dict__['mesh'].model_group, 0)

  def forward(self, ids: Tensor) -> Tensor:
    if self.slab is not None:
      # Slot ids of the batch's unique rows, all in range.
      return F.embedding(ids, self.slab).to(self.dtype)
    table = self.table()
    if table.shape[0] == 1:
      return table[0].to(self.dtype).expand(
          tuple(ids.shape) + (table.shape[1],))
    return take(table, ids).to(self.dtype)


@contextlib.contextmanager
def read_from_slabs(slabs: Mapping[nn.Module, Tensor]) -> Iterator[None]:
  """Inside, each encoder or ``Embed`` of ``slabs`` reads its rows from its
  slab, with the slot ids it is given, instead of from its table."""
  try:
    for encoder, slab in slabs.items():
      encoder.slab = slab
    yield
  finally:
    for encoder in slabs:
      encoder.slab = None
