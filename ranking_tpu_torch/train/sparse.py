"""Lazy (sparse-row) Adam and Adagrad for embedding tables.

The port's copy of ``ranking_tpu/train/sparse.py`` as the sparse train step
uses it (``train/steps.py`` ``make_sparse_train_step``). TF trains
embedding columns with ``IndexedSlices`` gradients, so an optimizer step
visits only the rows a batch touched; here the step deduplicates the
batch's ids (``compact_unique``), gathers a ``[K, dim]`` slab of those rows,
differentiates with respect to the slab, and ``LazyAdam.update_rows`` /
``LazyAdagrad.update_rows`` step the touched rows of the table and its
moments and write them back, in place, through the row scatter kernel of
``ops/cuda/rows.py``. Untouched rows receive no moment decay (TF-contrib
``LazyAdamOptimizer`` semantics); bias correction uses the global step
count.

Parameters are named by '/'-joined paths made from the ``nn.Module`` names
(``scorer/embed_query_tokens/embedding``), the JAX package's flax paths,
so that one ``table_pattern`` or ``EmbedFeature`` names the same table in
both packages.

The dense-gradient ``update`` of the JAX package (``_compact_touched_rows``,
``_lazy_update``, ``_lazy_adagrad_update``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import (Any, Callable, Dict, Mapping, Optional, Sequence, Tuple,
                    Union)

import torch

from ranking_tpu_torch.ops.cuda import rows as rows_lib

Tensor = torch.Tensor
Schedule = Union[float, Callable[[Tensor], Any]]
RowGrads = Mapping[str, Tuple[Tensor, Tensor, Tensor]]

_BIG = torch.iinfo(torch.int32).max


def compact_unique(flat_ids: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
  """Static-shape unique over a flat id vector, with no host
  synchronisation (``torch.unique`` would synchronise to size its output).

  Args:
    flat_ids: ``[N]`` integer ids; ids < 0 are padding. Ids must be below
      ``int32`` max (the internal padding key).

  Returns:
    ``(uids, remap, filled)``, all ``[N]``, int32, int32 and bool:
      * ``uids``: the distinct non-negative ids in ascending order in the
        first ``n_unique`` slots (the remaining slots hold 0);
      * ``remap``: for every input position, the slot its id landed in;
        padding positions keep their (negative) id;
      * ``filled``: the occupied slots of ``uids``.
  """
  n = flat_ids.shape[0]
  flat_ids = flat_ids.to(torch.int32)
  valid = flat_ids >= 0
  key = torch.where(valid, flat_ids, _BIG)
  iota = torch.arange(n, dtype=torch.int32, device=flat_ids.device)
  s, order = torch.sort(key, stable=True)
  valid_s = s != _BIG
  first = torch.cat([torch.ones((1,), dtype=torch.bool, device=s.device),
                     s[1:] != s[:-1]]) & valid_s
  firsti = first.to(torch.int32)
  urank = torch.cumsum(firsti, 0, dtype=torch.int32) - 1
  n_unique = torch.sum(firsti)
  # Compact the first occurrence of each run to the front.
  to_front = torch.sort(torch.where(first, urank, _BIG), stable=True).indices
  filled = iota < n_unique
  uids = torch.where(filled, s[to_front], 0)
  # remap[order[i]] = urank[i], the inverse permutation as a sort by
  # `order` (distinct keys).
  remap = urank[torch.sort(order).indices]
  remap = torch.where(valid, remap, flat_ids)
  return uids, remap, filled


def _compact_unique_reference(flat_ids: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
  """Scatter formulation of :func:`compact_unique`, for its tests."""
  n = flat_ids.shape[0]
  flat_ids = flat_ids.to(torch.int32)
  valid = flat_ids >= 0
  key = torch.where(valid, flat_ids, _BIG)
  order = torch.argsort(key, stable=True)
  s = key[order]
  valid_s = valid[order]
  first = torch.cat([torch.ones((1,), dtype=torch.bool, device=s.device),
                     s[1:] != s[:-1]]) & valid_s
  urank = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
  n_unique = torch.sum(first.to(torch.int32))
  uids = torch.zeros((n,), dtype=torch.int32, device=s.device)
  kept = torch.nonzero(valid_s).squeeze(1)
  uids[urank[kept].long()] = s[kept]
  filled = torch.arange(n, dtype=torch.int32, device=s.device) < n_unique
  remap = torch.zeros((n,), dtype=torch.int32, device=s.device)
  remap[order] = urank
  remap = torch.where(valid, remap, flat_ids)
  return uids, remap, filled


@dataclasses.dataclass(frozen=True)
class EmbedFeature:
  """Declares that a feature's ids feed an embedding table.

  The sparse train step remaps the feature's ids to batch-local slots,
  gathers the touched table rows and differentiates with respect to those
  rows only: the dense ``[vocab, dim]`` gradient never exists.
  """

  param_path: str          # '/'-joined path of the table parameter
  feature: str             # feature name carrying the ids
  source: str = 'examples'  # 'context' | 'examples'
  # Reduce ids modulo this before lookup (HashEmbeddingEncoder); None =
  # the table's own row count.
  num_buckets: Optional[int] = None


def path_str(name: str) -> str:
  """The '/'-joined path of a ``named_parameters`` name."""
  return name.replace('.', '/')


def named_paths(model: torch.nn.Module) -> Dict[str, Tensor]:
  """``{path: parameter}`` of a model, by '/'-joined paths."""
  return {path_str(n): p for n, p in model.named_parameters()}


def derive_embed_features(params: Mapping[str, Any],
                          context: Mapping[str, Tensor],
                          examples: Mapping[str, Tensor],
                          table_pattern: str = r'embedding',
                          ) -> Tuple[EmbedFeature, ...]:
  """EmbedFeatures for EmbeddingDNNScorer-style models: table parameters
  at ``.../embed_<feature>/embedding`` (``params`` keyed by path, e.g.
  ``named_paths(model)``) whose ``<feature>`` is in the batch. (The JAX
  package's branch for an encoder's token table waits for the encoder.)"""
  out = []
  for s in params:
    if not re.search(table_pattern, s):
      continue
    m = re.search(r'embed_([^/]+)/[^/]+$', s)
    if m:
      feat = m.group(1)
      if feat in context:
        out.append(EmbedFeature(param_path=s, feature=feat,
                                source='context'))
      elif feat in examples:
        out.append(EmbedFeature(param_path=s, feature=feat,
                                source='examples'))
  return tuple(out)


def _lr(learning_rate: Schedule, count: Tensor) -> Any:
  # A callable schedule receives the pre-increment (0-based) count, the
  # optax convention, so one schedule serves the dense and the lazy update.
  return learning_rate(count) if callable(learning_rate) else learning_rate


def _touched(uids: Tensor, g: Tensor, filled: Tensor) -> Tuple[Tensor, Tensor]:
  """A slot is touched iff it is filled and its gradient row is non-zero;
  (touched, its ids with the rest at 0)."""
  reduce_dims = tuple(range(1, g.ndim))
  touched = filled & (torch.sum(torch.abs(g), dim=reduce_dims) > 0)
  return touched, torch.where(touched, uids, 0)


@dataclasses.dataclass(frozen=True)
class LazyAdam:
  """Config of the sparse-row Adam applied to matching table parameters."""

  learning_rate: Schedule = 1e-3
  b1: float = 0.9
  b2: float = 0.999
  eps: float = 1e-8
  # Parameters whose path matches (re.search) get the lazy update; they
  # must be >= 2-D with the vocabulary as the leading axis.
  table_pattern: str = r'embedding'

  def matches(self, path: str) -> bool:
    return re.search(self.table_pattern, path) is not None

  def init(self, sparse_params: Mapping[str, Tensor]) -> Dict[str, Any]:
    """Moments as separate ``[vocab, dim]`` tensors beside each table.
    ``dropped`` keeps the JAX package's layout; only its dense-gradient
    update (not ported yet) writes it, so here it stays 0."""
    state: Dict[str, Any] = {
        p: {'m': torch.zeros_like(x), 'v': torch.zeros_like(x)}
        for p, x in sparse_params.items()}
    device = next(iter(sparse_params.values())).device if sparse_params \
        else None
    state['count'] = torch.zeros((), dtype=torch.int32, device=device)
    state['dropped'] = torch.zeros((), dtype=torch.int32, device=device)
    return state

  @torch.no_grad()
  def update_rows(
      self,
      row_grads: RowGrads,
      state: Dict[str, Any],
      sparse_params: Mapping[str, Tensor],
      row_params: Optional[Mapping[str, Tensor]] = None,
  ) -> Tuple[Mapping[str, Tensor], Dict[str, Any]]:
    """Row-level update for the sparse train step: O(K·dim) per table.

    ``row_grads`` maps table path -> ``(uids [K], grads [K, dim...],
    filled [K])`` from ``compact_unique`` and the gradients with respect to
    the gathered rows. Moments and parameters are gathered at the touched
    rows (``filled`` and a non-zero gradient), stepped, and written back in
    place into the tables, the moments and ``state['count']``.
    ``row_params`` optionally supplies the already-gathered rows
    ``table[uids]`` (the step's forward slab, a copy). Returns
    ``(sparse_params, state)``, updated.
    """
    lr = _lr(self.learning_rate, state['count'])
    count = state['count'] + 1
    t = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.full_like(t, self.b1), t)
    bc2 = 1.0 - torch.pow(torch.full_like(t, self.b2), t)
    use_kernel = rows_lib.enabled()
    for p, (uids, g, filled) in row_grads.items():
      table, m, v = sparse_params[p], state[p]['m'], state[p]['v']
      if table.ndim < 2:
        raise ValueError(
            f'LazyAdam table must be >= 2-D, got shape {tuple(table.shape)}')
      touched, safe = _touched(uids, g, filled)
      if row_params is not None and p in row_params:
        p_r = row_params[p]
      else:
        p_r = table.index_select(0, safe)
      m_r, v_r = m.index_select(0, safe), v.index_select(0, safe)
      new_m = self.b1 * m_r + (1.0 - self.b1) * g
      new_v = self.b2 * v_r + (1.0 - self.b2) * g * g
      # float32 arithmetic from here whatever the table's dtype, as the
      # JAX package's float32 bias corrections promote it.
      step = lr * (new_m.to(bc1.dtype) / bc1) / (
          torch.sqrt(new_v.to(bc2.dtype) / bc2) + self.eps)
      _scatter_rows_multi_auto((table, m, v), uids, touched,
                               (p_r - step, new_m, new_v), use_kernel)
    state['count'].add_(1)
    return sparse_params, state


@dataclasses.dataclass(frozen=True)
class LazyAdagrad:
  """Sparse-row Adagrad for embedding tables: one accumulator per table
  instead of Adam's two moments. On the touched rows it equals
  ``optax.adagrad``; untouched rows are untouched."""

  learning_rate: Schedule = 1e-3
  initial_accumulator_value: float = 0.1
  eps: float = 1e-7  # optax.adagrad's default
  table_pattern: str = r'embedding'

  def matches(self, path: str) -> bool:
    return re.search(self.table_pattern, path) is not None

  def init(self, sparse_params: Mapping[str, Tensor]) -> Dict[str, Any]:
    state: Dict[str, Any] = {
        p: {'acc': torch.full_like(x, self.initial_accumulator_value)}
        for p, x in sparse_params.items()}
    device = next(iter(sparse_params.values())).device if sparse_params \
        else None
    state['count'] = torch.zeros((), dtype=torch.int32, device=device)
    state['dropped'] = torch.zeros((), dtype=torch.int32, device=device)
    return state

  @torch.no_grad()
  def update_rows(
      self,
      row_grads: RowGrads,
      state: Dict[str, Any],
      sparse_params: Mapping[str, Tensor],
      row_params: Optional[Mapping[str, Tensor]] = None,
  ) -> Tuple[Mapping[str, Tensor], Dict[str, Any]]:
    """Row-level update, in place: 2 row slabs a table (parameter and
    accumulator) where LazyAdam writes 3; see ``LazyAdam.update_rows``."""
    lr = _lr(self.learning_rate, state['count'])
    use_kernel = rows_lib.enabled()
    for p, (uids, g, filled) in row_grads.items():
      table, acc = sparse_params[p], state[p]['acc']
      if table.ndim < 2:
        raise ValueError(
            f'LazyAdagrad table must be >= 2-D, got shape '
            f'{tuple(table.shape)}')
      touched, safe = _touched(uids, g, filled)
      if row_params is not None and p in row_params:
        p_r = row_params[p]
      else:
        p_r = table.index_select(0, safe)
      new_acc = acc.index_select(0, safe) + g * g
      step = lr * g * _adagrad_inv(new_acc, self.eps)
      _scatter_rows_multi_auto((table, acc), uids, touched,
                               (p_r - step, new_acc), use_kernel)
    state['count'].add_(1)
    return sparse_params, state


def _adagrad_inv(acc: Tensor, eps: float) -> Tensor:
  """optax.scale_by_rss's inverse root: rsqrt(acc + eps) where the
  accumulator is positive, 0 otherwise (a zero accumulator must not turn
  eps into a huge step)."""
  return torch.where(acc > 0, torch.rsqrt(acc + eps), 0.0)


# Routing of the row writes. In the JAX package the TPU kernel runs only
# inside an auto-domain (table.size > 2000 x rows, width 128): the
# crossover of XLA's scatter, which rewrites the whole table, against the
# TPU's DMA issue rate, and Mosaic's width limit. Neither exists on the
# card, where both paths cost O(rows), so every table goes to the kernel
# wrappers unless ops.cuda.rows.set_enabled has switched them off (then the
# plain versions run); on CPU tensors the wrappers compute their plain
# versions. Both paths compute the same function, so no result depends on
# the choice. A table of more than two dims is the same row copy over its
# flattened rows. The JAX package's `dma_scatter=False` and
# `_visibly_partitioned` exist for tables sharded over devices, which come
# with parallel/; until then no table is partitioned and the switch is not
# ported.


def _scatter_rows_multi_auto(bufs: Sequence[Tensor], uids: Tensor,
                             touched: Tensor, rows_list: Sequence[Tensor],
                             use_kernel: bool) -> Tuple[Tensor, ...]:
  """Optimizer-update scatter: all buffers (parameter and moments) share
  one shape and one id stream, so they go through one launch of the
  multi-table kernel (``n == 1`` is the single-table one). The table's
  dtype decides what is stored."""
  rows_list = [r.to(b.dtype) for b, r in zip(bufs, rows_list)]
  if not use_kernel:
    return rows_lib.scatter_rows_multi_reference(bufs, uids, touched,
                                                 rows_list)
  # Views, never copies: the kernel writes into the buffers' storage.
  flat = [b.view(b.shape[0], math.prod(b.shape[1:])) for b in bufs]
  flat_rows = [r.reshape(r.shape[0], math.prod(r.shape[1:]))
               for r in rows_list]
  rows_lib.scatter_rows_multi(flat, uids, touched, flat_rows)
  return tuple(bufs)


def partition(params: Mapping[str, Tensor], spec: Any
              ) -> Tuple[Dict[str, Optional[Tensor]], Dict[str, Tensor]]:
  """Splits ``{path: tensor}`` into (the dense dict with None at the table
  paths, ``{path: table}``)."""
  dense: Dict[str, Optional[Tensor]] = {}
  sparse: Dict[str, Tensor] = {}
  for s, leaf in params.items():
    if spec.matches(s):
      sparse[s] = leaf
      dense[s] = None
    else:
      dense[s] = leaf
  return dense, sparse


def merge(params: Mapping[str, Any], new_dense: Mapping[str, Any],
          new_sparse: Mapping[str, Any]) -> Dict[str, Any]:
  """Rebuilds ``{path: tensor}`` in the order of ``params`` from the dense
  dict and the tables."""
  return {s: new_sparse[s] if s in new_sparse else new_dense[s]
          for s in params}
