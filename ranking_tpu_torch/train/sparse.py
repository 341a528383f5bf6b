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
  ``named_paths(model)``) whose ``<feature>`` is in the batch; and, the
  EncoderScorer (TFR-BERT) convention, an encoder's ``token_embed`` table
  fed by the fused ``input_ids`` example feature."""
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
      continue
    if re.search(r'token_embed/[^/]+$', s) and 'input_ids' in examples:
      out.append(EmbedFeature(param_path=s, feature='input_ids',
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
  # The dense-gradient update's bound on the rows it steps a table and a
  # step; rows past it are dropped and counted in state['dropped'].
  max_rows: int = 8192

  def matches(self, path: str) -> bool:
    return re.search(self.table_pattern, path) is not None

  def init(self, sparse_params: Mapping[str, Tensor]) -> Dict[str, Any]:
    """Moments as separate ``[vocab, dim]`` tensors beside each table,
    the step ``count`` and the ``dropped`` rows of the dense-gradient
    update (int32 on the tables' device)."""
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
    step = self._row_step(state['count'])
    use_kernel = rows_lib.enabled()
    for p, (uids, g, filled) in row_grads.items():
      table, m, v = sparse_params[p], state[p]['m'], state[p]['v']
      _check_table(self, table)
      touched, safe = _touched(uids, g, filled)
      if row_params is not None and p in row_params:
        p_r = row_params[p]
      else:
        p_r = table.index_select(0, safe)
      _scatter_rows_multi_auto(
          (table, m, v), uids, touched,
          step(g, p_r, m.index_select(0, safe), v.index_select(0, safe)),
          use_kernel)
    state['count'].add_(1)
    return sparse_params, state

  def _row_step(self, count: Tensor):
    """The step of ``count`` (pre-increment) as a function of the rows'
    gradients, parameters and moments, giving their new values."""
    lr = _lr(self.learning_rate, count)
    t = (count + 1).to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.full_like(t, self.b1), t)
    bc2 = 1.0 - torch.pow(torch.full_like(t, self.b2), t)

    def step(g, p_r, m_r, v_r):
      new_m = self.b1 * m_r + (1.0 - self.b1) * g
      new_v = self.b2 * v_r + (1.0 - self.b2) * g * g
      # float32 arithmetic from here whatever the table's dtype, as the
      # JAX package's float32 bias corrections promote it.
      delta = lr * (new_m.to(bc1.dtype) / bc1) / (
          torch.sqrt(new_v.to(bc2.dtype) / bc2) + self.eps)
      return p_r - delta, new_m, new_v

    return step

  @torch.no_grad()
  def update(
      self,
      sparse_grads: Mapping[str, Tensor],
      state: Dict[str, Any],
      sparse_params: Mapping[str, Tensor],
  ) -> Tuple[Mapping[str, Tensor], Dict[str, Any]]:
    """Dense-gradient update: ``sparse_grads`` maps a table path to the
    table's whole gradient. The rows with a non-zero gradient, at most
    ``max_rows`` of them, are stepped as ``update_rows`` steps them and
    written back in place into the tables and the moments; rows past the
    bound keep their values and add to ``state['dropped']``. A table
    without a gradient keeps its state. Returns ``(sparse_params, state)``,
    updated."""
    step = self._row_step(state['count'])
    for p, g in sparse_grads.items():
      table, m, v = sparse_params[p], state[p]['m'], state[p]['v']
      _check_table(self, table)
      idx, filled, n_dropped = _compact_touched_rows(g, self.max_rows,
                                                     table.shape[0])
      _write_compacted((table, m, v), idx, filled, step(
          g.index_select(0, idx), table.index_select(0, idx),
          m.index_select(0, idx), v.index_select(0, idx)))
      state['dropped'].add_(n_dropped)
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
  max_rows: int = 8192  # as LazyAdam's

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
    step = self._row_step(state['count'])
    use_kernel = rows_lib.enabled()
    for p, (uids, g, filled) in row_grads.items():
      table, acc = sparse_params[p], state[p]['acc']
      _check_table(self, table)
      touched, safe = _touched(uids, g, filled)
      if row_params is not None and p in row_params:
        p_r = row_params[p]
      else:
        p_r = table.index_select(0, safe)
      _scatter_rows_multi_auto((table, acc), uids, touched,
                               step(g, p_r, acc.index_select(0, safe)),
                               use_kernel)
    state['count'].add_(1)
    return sparse_params, state

  def _row_step(self, count: Tensor):
    """The step of ``count`` (pre-increment) as a function of the rows'
    gradients, parameters and accumulators, giving their new values."""
    lr = _lr(self.learning_rate, count)

    def step(g, p_r, acc_r):
      new_acc = acc_r + g * g
      return p_r - lr * g * _adagrad_inv(new_acc, self.eps), new_acc

    return step

  @torch.no_grad()
  def update(
      self,
      sparse_grads: Mapping[str, Tensor],
      state: Dict[str, Any],
      sparse_params: Mapping[str, Tensor],
  ) -> Tuple[Mapping[str, Tensor], Dict[str, Any]]:
    """Dense-gradient update, in place; see ``LazyAdam.update``."""
    step = self._row_step(state['count'])
    for p, g in sparse_grads.items():
      table, acc = sparse_params[p], state[p]['acc']
      _check_table(self, table)
      idx, filled, n_dropped = _compact_touched_rows(g, self.max_rows,
                                                     table.shape[0])
      _write_compacted((table, acc), idx, filled, step(
          g.index_select(0, idx), table.index_select(0, idx),
          acc.index_select(0, idx)))
      state['dropped'].add_(n_dropped)
    state['count'].add_(1)
    return sparse_params, state


def _check_table(spec, table: Tensor) -> None:
  if table.ndim < 2:
    raise ValueError(f'{type(spec).__name__} table must be >= 2-D, got '
                     f'shape {tuple(table.shape)}')


def _compact_touched_rows(g: Tensor, max_rows: int, n_table_rows: int
                          ) -> Tuple[Tensor, Tensor, Tensor]:
  """The ids of the rows with a non-zero gradient, in ascending order, in
  the first slots of a ``[k]`` buffer, ``k = min(max_rows, rows)``: row r
  goes to slot (touched rows before r). O(rows), no sort, and no host
  synchronisation, so that a CUDA graph captures it: a touched row past
  slot k - 1 goes to a dump slot k of a ``[k + 1]`` buffer, which is then
  cut off.

  Returns ``(idx [k] int64, filled [k] bool, n_dropped)``: the unfilled
  slots hold 0; ``n_dropped`` (int32, 0-d) counts the touched rows that
  found no slot.
  """
  touched = torch.sum(torch.abs(g), dim=tuple(range(1, g.ndim))) > 0
  k = min(max_rows, n_table_rows)
  n = touched.shape[0]
  slot = torch.clamp(torch.cumsum(touched.to(torch.int64), 0) - 1, max=k)
  slot = torch.where(touched, slot, k)
  rows = torch.arange(n, dtype=torch.int64, device=g.device)
  idx = torch.zeros((k + 1,), dtype=torch.int64, device=g.device).scatter_(
      0, slot, rows)[:k]
  n_rows = torch.sum(touched, dtype=torch.int32)
  filled = torch.arange(k, device=g.device) < n_rows
  return idx, filled, torch.clamp(n_rows - k, min=0)


def _write_compacted(bufs: Sequence[Tensor], idx: Tensor, filled: Tensor,
                     rows_list: Sequence[Tensor]) -> None:
  """Writes row i of each of ``rows_list`` into row ``idx[i]`` of its
  buffer where ``filled[i]``, in place, and nothing else: the JAX package's
  ``.at[dest].set(rows, mode='drop')`` with no host synchronisation. Every
  unfilled slot writes the row of slot 0 (``idx[0]``) with the value slot 0
  writes, or that row's own value when slot 0 is unfilled too, so that the
  duplicate writes of one row carry the same bits and the order in which
  ``index_copy_`` lands them does not matter. The buffer's dtype decides
  what is stored."""
  first = idx[:1]
  dest = torch.where(filled, idx, first)
  for buf, rows in zip(bufs, rows_list):
    rows = rows.to(buf.dtype)
    shape = (-1,) + (1,) * (rows.ndim - 1)
    head = torch.where(filled[:1].reshape(shape), rows[:1],
                       buf.index_select(0, first))
    buf.index_copy_(0, dest, torch.where(filled.reshape(shape), rows, head))


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
# `_visibly_partitioned` (ranking_tpu/train/sparse.py:205-209, :362-372)
# turn its kernel off on tables sharded over devices, because XLA's SPMD
# partitioner cannot partition a custom call. Here a rank's shard of a
# row-sharded table (parallel/) is a plain local tensor: the sparse step
# hands `update_rows` the shard's own ids of the rows the rank owns, and the
# kernel writes them into the shard and its moments as it writes a whole
# table on one card. So the switch is not ported, and the kernel stays on
# under a mesh.


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
