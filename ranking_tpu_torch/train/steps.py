"""The train and eval steps.

The port's copy of ``ranking_tpu/train/steps.py``:

* ``train_step(state, batch, generator=None) -> (state, metrics)``: forward
  in train mode, loss, backward, optimizer update and the batch-statistics
  update, in place on ``state.model`` and ``state.optimizer``; the
  generator feeds dropout and the loss's tie shuffles;
* ``eval_step(model, batch, metric_states) -> (metric_states, logits)``:
  forward in eval mode, every metric streamed into a ``MeanState``; on
  CUDA ``GraphedEvalStep`` replays it as one CUDA graph a batch shape;
* the sparse train step (``make_sparse_train_step``), whose embedding
  gradients exist only for the rows a batch touched.

All of them keep their results on the device and never synchronize with the
host.

Each takes a ``parallel.Mesh`` (None: a mesh of one, on which every
collective is the identity). Every rank of the mesh calls the step on the
same global batch, and the step is the one-card step on that batch (the JAX
package's SPMD semantics), up to float32 summation order: the forward runs on this rank's rows (``parallel.shard_batch``) with
batch statistics and dropout masks of the global batch; the logits are
gathered over the data group (``comm.gather_replicated``) and every rank
computes the loss of the whole batch, so every batch-level statistic,
random draw and reduction of a loss is the one-card one (``UniqueSoftmax``'s
batch minimum, the Gumbel samples, Σ num / Σ den over ranks with unequal
valid counts); the backward gives each rank its rows' share of every
gradient, which the data group sums before the optimizer steps. Ranks of a
model group hold the same rows and parameter shards, and agree.
"""

from __future__ import annotations

import itertools
from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional,
                    Tuple, Union)

import torch

from ranking_tpu_torch.data import batch as batch_lib
from ranking_tpu_torch.data.batch import RankingBatch
from ranking_tpu_torch.models import embeddings as emb_lib
from ranking_tpu_torch.ops.metric_registry import MeanState
from ranking_tpu_torch.parallel import comm
from ranking_tpu_torch.parallel import mesh as mesh_lib
from ranking_tpu_torch.parallel.embedding import ShardedEmbeddingEncoder
from ranking_tpu_torch.train import sparse as sparse_lib
from ranking_tpu_torch.train.state import TrainState
from ranking_tpu_torch.utils import list_ops
from ranking_tpu_torch.utils.device import DeviceLike, resolve_device

Tensor = torch.Tensor
LossFn = Callable[..., Tensor]
MetricFn = Callable[..., Tuple[Tensor, Tensor]]


def _masked_mean(values: Tensor, mask: Tensor) -> Tensor:
  mask = mask.to(torch.float32)
  # Multi-unit heads ([B, L, units] logits) broadcast the [B, L] mask.
  if values.ndim > mask.ndim:
    mask = mask.reshape(mask.shape + (1,) * (values.ndim - mask.ndim))
  denom = torch.clamp(torch.sum(mask.expand(values.shape)), min=1.0)
  return torch.sum(values * mask) / denom


def restore_flat_examples(batch: RankingBatch) -> RankingBatch:
  """Restores ``[B*L, ...]`` example features to ``[B, L, ...]``.

  The host side of the pair is ``data.dataset.flatten_examples``. A leaf is
  restored iff its leading axis is ``B*L`` (mask gives B, L), exactly the
  JAX package's predicate; L == 1 batches are returned untouched.
  """
  b, l = batch.mask.shape
  if l <= 1:
    return batch
  examples = {
      k: (v.reshape((b, l) + tuple(v.shape[1:]))
          if v.ndim >= 1 and v.shape[0] == b * l else v)
      for k, v in batch.examples.items()}
  return batch.replace(examples=examples)


def _make_total_loss(loss_fn, multi_task_weights):
  """Single or dict-of-task loss -> scalar total-loss closure."""
  if (isinstance(loss_fn, Mapping) and multi_task_weights
      and not set(multi_task_weights) <= set(loss_fn)):
    # A mistyped task name would otherwise be silently ignored.
    raise ValueError(
        f'multi_task_weights names unknown tasks '
        f'{sorted(set(multi_task_weights) - set(loss_fn))}; '
        f'tasks are {sorted(loss_fn)}')

  def _total_loss(labels, logits, features, generator=None):
    # Every task draws from the one generator in turn; without one, a loss
    # fn is called as (labels, logits, features=...).
    extra = {} if generator is None else {'generator': generator}
    if isinstance(loss_fn, Mapping):
      total = 0.0
      for task, fn in sorted(loss_fn.items()):
        w = 1.0 if not multi_task_weights else multi_task_weights.get(task, 1.)
        total = total + w * fn(labels[task], logits[task], features=features,
                               **extra)
      return total
    return loss_fn(labels, logits, features=features, **extra)

  return _total_loss


def _sanity_metrics(loss: Tensor, batch: RankingBatch,
                    logits) -> Dict[str, Tensor]:
  """Loss + labels/logits means mirroring the reference head
  (python/head.py:216-223)."""
  ref_logits = (logits if not isinstance(logits, dict)
                else next(iter(sorted(logits.items())))[1])
  ref_labels = (batch.labels if not isinstance(batch.labels, dict)
                else next(iter(sorted(batch.labels.items())))[1])
  return {
      'loss': loss.detach(),
      'labels_mean': _masked_mean(ref_labels, batch.mask),
      'logits_mean': _masked_mean(ref_logits.detach(), batch.mask),
  }


def _gather_rows(logits, mesh: mesh_lib.Mesh):
  """This rank's logits gathered over the data group (every rank then
  holds the global batch's), with the own-slice backward."""
  if isinstance(logits, Mapping):
    return {k: comm.gather_replicated(v, mesh.data_group, 0)
            for k, v in logits.items()}
  return comm.gather_replicated(logits, mesh.data_group, 0)


def _attach_mesh(state: TrainState, mesh: mesh_lib.Mesh) -> None:
  """Gives the dense optimizer the global norm of its gradients (for
  ``clip_norm``): squares of model-sharded gradients are summed over the
  model group as well."""
  opt = state.optimizer
  if opt is None or getattr(opt, 'mesh', None) is mesh:
    return
  shards = {id(p) for n, p in state.model.named_parameters()
            if n in mesh_lib.sharded_dims(state.model)}
  opt.mesh = mesh
  opt.sharded_grads = shards


def _data_parallel_backward(model, batch: RankingBatch, generator,
                            mesh: mesh_lib.Mesh, total_loss):
  """Forward on this rank's rows, loss of the global batch, backward, and
  the data group's sum of the gradients of ``model``'s parameters.
  Returns the gathered logits and the loss."""
  local = mesh_lib.shard_batch(batch, mesh)
  extra = {} if generator is None else {'generator': generator}
  with comm.active(mesh):
    logits = model(local.context, local.examples, local.mask, training=True,
                   **extra)
    logits = _gather_rows(logits, mesh)
    loss = total_loss(batch.labels, logits, batch.features, generator)
    loss.backward()
  comm.all_reduce_grads(list(model.parameters()), mesh.data_group)
  return logits, loss


def make_train_step(
    loss_fn: Any,
    multi_task_weights: Optional[Mapping[str, float]] = None,
    device: DeviceLike = 'cuda',
    mesh: Optional[mesh_lib.Mesh] = None,
) -> Callable[..., Tuple[TrainState, Dict[str, Tensor]]]:
  """Builds ``train_step(state, batch, generator=None) -> (state, metrics)``.

  ``loss_fn(labels, logits, features=None, generator=None) -> scalar`` as
  built by ``ops.loss_registry.make_loss_fn``; for multi-task models pass a
  dict ``{task: loss_fn}`` and the batch carries dict labels. The batch
  moves to ``device``; the state (``train.state.create_train_state``) must
  already be there. ``generator`` (on ``device``) is the step's one random
  stream, where the JAX step splits a key four ways: the forward draws its
  dropout masks from it, then the loss its tie shuffles. None means no
  dropout (a model with dropout raises) and deterministic ties.

  The step updates ``state`` in place and returns it: parameters and
  optimizer moments by the optimizer, running batch statistics by the
  train-mode forward. Metrics are 0-d tensors on the device.

  On a state with a ``sparse_tx`` the tables are differentiated whole and
  their dense gradients go to ``sparse_tx.update`` (the dense-gradient
  lazy update, ``TrainState.apply_gradients``); ``make_sparse_train_step``
  is the step that never builds them, where batch features name the
  tables.

  ``mesh``: every rank calls the step on the global batch (module
  docstring); a row-sharded table's gradient and lazy update are the
  rank's shard's.
  """
  device = resolve_device(device)
  mesh = mesh or mesh_lib.Mesh(1, 1)
  _total_loss = _make_total_loss(loss_fn, multi_task_weights)

  def train_step(state: TrainState, batch: RankingBatch,
                 generator: Optional[torch.Generator] = None):
    batch = restore_flat_examples(batch.to(device))
    state.zero_grad()
    _attach_mesh(state, mesh)
    logits, loss = _data_parallel_backward(state.model, batch, generator,
                                           mesh, _total_loss)
    state.apply_gradients()
    state.step += 1
    return state, _sanity_metrics(loss, batch, logits)

  return train_step


def _group_by_table(embed_features, tables: Mapping[str, Tensor]):
  """``{param_path: [EmbedFeature]}``, after the checks of the JAX step:
  every table covered, no unknown path, no feature feeding two tables."""
  declared = {ef.param_path for ef in embed_features}
  uncovered = set(tables) - declared
  if uncovered:
    raise ValueError(
        f'sparse tables with no declared id feature: {sorted(uncovered)}; '
        'declare them in embed_features or narrow table_pattern')
  unknown = declared - set(tables)
  if unknown:
    raise ValueError(
        f'embed_features declare param_paths that match no sparse table: '
        f'{sorted(unknown)}; sparse tables are {sorted(tables)}')
  # Features sharing one table share one dedup and one slab.
  by_path: Dict[str, list] = {}
  for ef in embed_features:
    by_path.setdefault(ef.param_path, []).append(ef)
  # The step rewrites a feature to slot ids of ITS table, so a second table
  # reading the same feature would train wrong rows with no error.
  seen: Dict[Tuple[str, str], str] = {}
  for path, group in by_path.items():
    for ef in group:
      k = (ef.source, ef.feature)
      if k in seen and seen[k] != path:
        raise ValueError(
            f'feature {ef.feature!r} ({ef.source}) feeds two sparse '
            f'tables ({seen[k]!r} and {path!r}); the sparse step '
            'rewrites features to per-table slot ids, so each feature '
            'can feed one table: duplicate the feature under another '
            'name')
      seen[k] = path
  return by_path


def _owned_slab(table: Tensor, uids: Tensor, mesh: mesh_lib.Mesh
                ) -> Tuple[Tensor, Tensor, Tensor]:
  """The ``[K, dim]`` slab of a table row-sharded over the model group:
  each rank contributes the rows of ``uids`` that its shard owns, and one
  all-reduce over the group assembles them (outside autodiff), so that the
  slab is the one-card one bit for bit. Returns ``(slab, local ids, owned)``:
  the ids of ``uids`` in the shard (0 where not owned) and which it owns."""
  rows = table.shape[0]
  lo = mesh.model_index * rows
  owned = (uids >= lo) & (uids < lo + rows)
  local = torch.where(owned, uids - lo, 0)
  part = torch.where(owned[:, None], table.detach().index_select(0, local),
                     0.0)
  return comm.all_reduce(part, mesh.model_group), local, owned


def make_sparse_train_step(
    loss_fn: Any,
    embed_features: Any,
    multi_task_weights: Optional[Mapping[str, float]] = None,
    device: DeviceLike = 'cuda',
    mesh: Optional[mesh_lib.Mesh] = None,
) -> Callable[..., Tuple[TrainState, Dict[str, Tensor]]]:
  """Train step whose embedding gradients never exist densely.

  The port of the JAX package's ``make_sparse_train_step``, the equivalent
  of TF's ``IndexedSlices`` path (python/feature.py:79-133), with cost
  bounded by the batch:

  1. each table's declared id features are reduced modulo its row count
     (or ``num_buckets``) where they are ids (>= 0), deduplicated together
     with ``sparse.compact_unique`` and rewritten to batch-local slots;
  2. the touched rows are gathered into a ``[K, dim]`` slab per table, a
     copy (``index_select``: the update reuses it as the rows' old values
     while it writes the table), and each encoder reads its slab inside the
     forward (``embeddings.read_from_slabs``);
  3. the backward gives the dense parameters' gradients and the slabs';
     the dense optimizer steps the first, ``state.sparse_tx.update_rows``
     the touched rows of each table and its moments, in place.

  ``embed_features``: ``sparse.EmbedFeature``s; every table that the state's
  ``sparse_tx`` matches must be covered. The batch moves to ``device``; the
  state (``create_train_state(..., sparse_tx=...)``) must already be there.
  ``generator`` as in ``make_train_step``. Metrics are computed on the batch
  as given, not the remapped one.

  ``mesh``: every rank deduplicates the global batch's ids alike; a table
  row-sharded over the model group (``ShardedEmbeddingEncoder``, or
  ``shard_module``'s) gives its slab from the rows each rank owns
  (``_owned_slab``), the slab's gradient is summed over the data group
  with the dense ones, and each rank writes the rows it owns of its shard
  and of its moments, through the row scatter kernel (row 10) on the local
  shard, as on one card.
  """
  device = resolve_device(device)
  mesh = mesh or mesh_lib.Mesh(1, 1)
  embed_features = tuple(embed_features)
  _total_loss = _make_total_loss(loss_fn, multi_task_weights)

  def train_step(state: TrainState, batch: RankingBatch,
                 generator: Optional[torch.Generator] = None):
    if state.sparse_tx is None:
      raise ValueError('make_sparse_train_step requires a TrainState built '
                       'with sparse_tx (train.sparse.LazyAdam or '
                       'LazyAdagrad)')
    batch = restore_flat_examples(batch.to(device))
    _, tables = sparse_lib.partition(sparse_lib.named_paths(state.model),
                                     state.sparse_tx)
    by_path = _group_by_table(embed_features, tables)
    context = dict(batch.context)
    examples = dict(batch.examples)
    slabs: Dict[str, Tensor] = {}
    info: Dict[str, Tuple[Tensor, Tensor]] = {}
    for path, group in by_path.items():
      table = tables[path]
      encoder = state.model.get_submodule('.'.join(path.split('/')[:-1]))
      sharded = 'embedding' in encoder.__dict__.get('model_shards', ())
      # A sharded table's ids address the whole (padded) table.
      n_rows = table.shape[0] * (mesh.model if sharded else 1)
      ids_list = []
      for ef in group:
        # Raw ids from the batch as given: `context` and `examples` are
        # rewritten to slot ids as the loop goes.
        src = batch.context if ef.source == 'context' else batch.examples
        ids = src[ef.feature]
        modulus = ef.num_buckets or n_rows
        ids_list.append(torch.where(ids >= 0, torch.remainder(ids, modulus),
                                    ids))
      flat = torch.cat([i.reshape(-1) for i in ids_list])
      uids, remap, filled = sparse_lib.compact_unique(flat)
      offset = 0
      for ef, ids in zip(group, ids_list):
        dst = context if ef.source == 'context' else examples
        dst[ef.feature] = remap[offset:offset + ids.numel()].reshape(
            ids.shape)
        offset += ids.numel()
      if sharded:
        slab, local, owned = _owned_slab(table, uids, mesh)
        slabs[path] = slab.requires_grad_()
        info[path] = (local, filled & owned)
      else:
        slabs[path] = table.detach().index_select(0, uids).requires_grad_()
        info[path] = (uids, filled)
    batch2 = batch.replace(context=context, examples=examples)
    encoders = {}
    for path, slab in slabs.items():
      encoder = state.model.get_submodule('.'.join(path.split('/')[:-1]))
      if not isinstance(encoder, (emb_lib.EmbeddingEncoder, emb_lib.Embed,
                                  ShardedEmbeddingEncoder)):
        raise ValueError(
            f'sparse table {path!r} belongs to a {type(encoder).__name__}; '
            'the sparse step redirects the lookups of EmbeddingEncoder and '
            'Embed modules only')
      encoders[encoder] = slab

    state.optimizer.zero_grad(set_to_none=True)
    _attach_mesh(state, mesh)
    with emb_lib.read_from_slabs(encoders):
      logits, loss = _data_parallel_backward(state.model, batch2, generator,
                                             mesh, _total_loss)
    comm.all_reduce_grads(list(slabs.values()), mesh.data_group)
    state.optimizer.step()
    row_grads = {p: (info[p][0], slabs[p].grad, info[p][1]) for p in slabs}
    state.sparse_tx.update_rows(
        row_grads, state.sparse_opt_state, tables,
        row_params={p: s.detach() for p, s in slabs.items()})
    state.step += 1
    return state, _sanity_metrics(loss, batch, logits)

  return train_step


def stack_batches(batches: List[RankingBatch]) -> RankingBatch:
  """K batches of one shape as one batch with a leading steps axis."""
  return batch_lib.stack_numpy_batches(batches)


def _step_batch(stacked: RankingBatch, k: int) -> RankingBatch:
  return RankingBatch(
      context={n: v[k] for n, v in stacked.context.items()},
      examples={n: v[k] for n, v in stacked.examples.items()},
      labels=({n: v[k] for n, v in stacked.labels.items()}
              if isinstance(stacked.labels, dict) else stacked.labels[k]),
      mask=stacked.mask[k])


def _leaves(batch: RankingBatch) -> List[Tensor]:
  labels = ([batch.labels[k] for k in sorted(batch.labels)]
            if isinstance(batch.labels, dict) else [batch.labels])
  return ([batch.context[k] for k in sorted(batch.context)]
          + [batch.examples[k] for k in sorted(batch.examples)]
          + labels + [batch.mask])


def _signature(batch: RankingBatch) -> tuple:
  """What a captured step depends on in a batch: names, shapes, dtypes."""
  return (tuple(sorted(batch.context)), tuple(sorted(batch.examples)),
          tuple(sorted(batch.labels)) if isinstance(batch.labels, dict)
          else None,
          tuple((tuple(t.shape), t.dtype) for t in _leaves(batch)))


def _clone(batch: RankingBatch) -> RankingBatch:
  """A copy of every tensor of a batch: the static inputs of a graph."""
  return RankingBatch(
      context={n: v.clone() for n, v in batch.context.items()},
      examples={n: v.clone() for n, v in batch.examples.items()},
      labels=({n: v.clone() for n, v in batch.labels.items()}
              if isinstance(batch.labels, dict) else batch.labels.clone()),
      mask=batch.mask.clone())


def _tensors(tree) -> Iterator[Tensor]:
  if torch.is_tensor(tree):
    yield tree
  elif isinstance(tree, Mapping):
    for value in tree.values():
      yield from _tensors(value)
  elif isinstance(tree, (list, tuple)):
    for value in tree:
      yield from _tensors(value)


def state_addresses(state: TrainState) -> Tuple[int, ...]:
  """The addresses of every tensor of ``state`` that a train step reads or
  writes, in a fixed order: the model's parameters and buffers, the dense
  optimizer's state (moments, step tensors), its rate and count, and the
  lazy-row optimizer's state. A captured step is bound to them."""
  opt = state.optimizer
  extra = [getattr(opt, 'count', None)] + [g['lr'] for g in opt.param_groups]
  tensors = itertools.chain(state.model.parameters(), state.model.buffers(),
                            _tensors(list(opt.state.values())),
                            _tensors(extra),
                            _tensors(state.sparse_opt_state))
  return tuple(t.data_ptr() for t in tensors)


def kernel_launch_counts() -> Dict[str, int]:
  """The launch count of every kernel wrapper of the port, by name."""
  from ranking_tpu_torch.ops.cuda import dense, fused_bn, pairwise, rows
  from ranking_tpu_torch.ops.cuda import sort as cuda_sort
  wrappers = ((cuda_sort.sorted_values_and_ranks,) + fused_bn.KERNEL_WRAPPERS
              + pairwise.KERNEL_WRAPPERS + rows.KERNEL_WRAPPERS
              + dense.KERNEL_WRAPPERS)
  return {fn.__name__: fn.launches for fn in wrappers}


class GraphedSteps:
  """K train steps per call on CUDA: one step captured in a CUDA graph.

  The first ``warmup`` steps that reach it run eagerly on a side stream
  (they build the kernels, the optimizer's state and the allocator's
  blocks, as capture requires); the next step is captured, reading static
  copies of its batch, and replayed, and so is every later one: before
  replay k the batch of step k is copied into the static buffers. The
  captured call leaves no work behind (capture records, it does not run),
  so every step of a call is either an eager warm-up step or one replay.
  The graph is bound to the addresses of the tensors it read and wrote:
  another state or generator object, a change of the batch's names, shapes
  or dtypes, or a state tensor that now lives elsewhere (a restored
  optimizer's new moments, a replaced parameter; ``state_addresses``)
  warms up and captures anew. A generator that the step reads is
  registered with the graph, so that each replay draws new numbers from it.

  The kernel wrappers count their launches where they run, and in a graph
  that is once, at capture: ``captured_launches`` holds what the capture
  recorded (name -> count), and ``replays`` how often the graph ran, so
  that launches on the card = eager counts + captured x replays.

  Metrics come back as ``[K]`` float32 tensors on the device, cloned out of
  the graph's static outputs; nothing in a call synchronizes with the host.
  ``state.step`` advances by K. A failed capture raises.
  """

  warmup = 3  # eager steps before the capture

  def __init__(self, train_step: Callable[..., Tuple[TrainState,
                                                     Dict[str, Tensor]]]):
    self.train_step = train_step
    self.graph = None
    self.captures = 0
    self.replays = 0
    self.captured_launches: Dict[str, int] = {}
    # The state and generator the warm-up or the graph belongs to, held so
    # that their ids and addresses are not reused while it lives.
    self._state = self._generator = None
    self._key = None
    self._eager = 0
    self._names: Optional[List[str]] = None

  def _eager_step(self, state, batch, generator):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
      state, metrics = self.train_step(state, batch, generator)
      self._names = list(metrics)
      row = torch.stack([metrics[n].to(torch.float32) for n in self._names])
    torch.cuda.current_stream().wait_stream(side)
    self._eager += 1
    return state, row

  def _capture(self, state, batch, generator):
    self._static_batch = _clone(batch)
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
      graph.register_generator_state(generator)
    before = kernel_launch_counts()
    step = state.step
    try:
      with torch.cuda.graph(graph):
        _, metrics = self.train_step(state, self._static_batch, generator)
        self._static_metrics = torch.stack(
            [metrics[n].to(torch.float32) for n in self._names])
    except Exception as e:
      raise RuntimeError(
          f'capturing the train step in a CUDA graph failed: {e}') from e
    state.step = step  # the captured call recorded a step, it ran none
    after = kernel_launch_counts()
    self.captured_launches = {n: after[n] - before[n] for n in after
                              if after[n] != before[n]}
    self.graph = graph
    self.captures += 1

  def __call__(self, state: TrainState, stacked_batch: RankingBatch,
               generator: Optional[torch.Generator] = None):
    num_steps = stacked_batch.mask.shape[0]
    signature = _signature(_step_batch(stacked_batch, 0))
    if (state is not self._state or generator is not self._generator
        or (signature, state_addresses(state)) != self._key):
      self.graph, self._eager = None, 0
      self._state, self._generator = state, generator
    rows = []
    for k in range(num_steps):
      batch = _step_batch(stacked_batch, k)
      if self.graph is None and self._eager < self.warmup:
        state, row = self._eager_step(state, batch, generator)
        rows.append(row)
        continue
      if self.graph is None:
        self._capture(state, batch, generator)
      for dst, src in zip(_leaves(self._static_batch), _leaves(batch)):
        dst.copy_(src)
      self.graph.replay()
      self.replays += 1
      state.step += 1
      rows.append(self._static_metrics.clone())
    # After the call: the warm-up steps create the optimizer's state.
    self._key = (signature, state_addresses(state))
    columns = torch.stack(rows, dim=1)
    return state, {n: columns[i] for i, n in enumerate(self._names)}


def make_multi_step(
    train_step: Callable[..., Tuple[TrainState, Dict[str, Tensor]]],
    device: DeviceLike = 'cuda',
    eager: bool = False,
) -> Callable[..., Tuple[TrainState, Dict[str, Tensor]]]:
  """Wraps a train_step to run K steps per call.

  The port of the JAX package's ``make_multi_step`` (K steps in one
  ``lax.scan`` dispatch, the reference's ``steps_per_execution``). The batch
  argument has a leading steps axis on every leaf (``stack_batches``); the
  returned metrics are per-step ``[K]`` tensors.

  On CUDA the steps are replays of one captured step (``GraphedSteps``).
  ``eager=True`` runs them as a Python loop of eager steps instead, as the
  CPU does; it exists as the yardstick of the graph.
  """
  device = resolve_device(device)
  if device.type == 'cuda' and not eager:
    return GraphedSteps(train_step)

  def multi_step(state: TrainState, stacked_batch: RankingBatch,
                 generator: Optional[torch.Generator] = None):
    per_step = []
    for k in range(stacked_batch.mask.shape[0]):
      state, metrics = train_step(state, _step_batch(stacked_batch, k),
                                  generator)
      per_step.append(metrics)
    return state, {name: torch.stack([m[name] for m in per_step])
                   for name in per_step[0]}

  return multi_step


def _task_inputs(name: str, batch: RankingBatch, logits):
  """The logits and labels that the metric ``name`` scores: for a dict of
  task logits, ``task/metric`` names route to that task (an unknown task
  raises: a typo must not score the wrong head) and other names to the
  first task in sorted order."""
  if not isinstance(logits, Mapping):
    return logits, batch.labels
  task, sep, _ = name.partition('/')
  if sep and task not in logits:
    raise ValueError(f'Metric {name!r} routes to unknown task {task!r}; '
                     f'model tasks: {sorted(logits)}')
  first = lambda tree: next(iter(sorted(tree.items())))[1]  # noqa: E731
  task_logits = logits[task] if sep else first(logits)
  labels = batch.labels
  if isinstance(labels, Mapping):
    labels = labels[task] if sep else first(labels)
  return task_logits, labels


def make_eval_step(
    metric_fns: Mapping[str, MetricFn],
    loss_fn: Optional[Any] = None,
    multi_task_weights: Optional[Mapping[str, float]] = None,
    device: DeviceLike = 'cuda',
    mesh: Optional[mesh_lib.Mesh] = None,
) -> Callable[..., Tuple[Dict[str, MeanState], Any]]:
  """Builds ``eval_step(model, batch, metric_states, num_valid_rows=None)
  -> (metric_states, logits)``.

  ``metric_fns`` maps display name -> fn from
  ``ops.metric_registry.make_ranking_metric_fn``. For a multi-task model
  (dict logits and labels), ``task/metric`` names route to that task's
  logits and labels; an unknown ``task/`` prefix raises, and a name
  without ``/`` takes the first task in sorted order. The batch moves to
  ``device``; the model must already be there.

  If ``loss_fn`` is given (as to ``make_train_step``: one fn, or a dict
  ``{task: fn}`` weighted by ``multi_task_weights``), the total loss
  streams into a reserved ``'loss'`` state weighted by the batch's count of
  lists with a valid item (the reference's val_loss). It is computed
  without a generator, as the JAX step passes no key.

  ``mesh``: every rank calls the step on the global batch (a multiple of
  the data axis: the pipeline pads a ragged one and passes
  ``num_valid_rows``); each scores its rows, so its states hold its rows'
  sums, and ``metric_results(states, mesh)`` sums them over the data group.
  The loss is the global batch's, from the gathered logits, streamed by the
  first rank of each data group only. The logits returned are the global
  batch's.
  """
  device = resolve_device(device)
  mesh = mesh or mesh_lib.Mesh(1, 1)
  if loss_fn is not None and 'loss' in metric_fns:
    raise ValueError("'loss' is reserved for the validation loss state; "
                     'rename the metric.')
  total_loss = (None if loss_fn is None
                else _make_total_loss(loss_fn, multi_task_weights))

  @torch.no_grad()
  def eval_step(model, batch: RankingBatch,
                metric_states: Dict[str, MeanState],
                num_valid_rows: Union[int, Tensor, None] = None):
    """``num_valid_rows`` (an int or a 0-d integer tensor on ``device``):
    rows >= this index are padding (RankingBatch.pad_to) and get metric
    weight 0. An all-invalid list is not weightless in the reference's
    metric semantics (NDCG gives it value 0, weight 1), so padded rows
    would otherwise bias every unweighted metric down. None = every row is
    real data."""
    batch = restore_flat_examples(batch.to(device))
    local = mesh_lib.shard_batch(batch, mesh)
    first_row = mesh.row_block(batch.batch_size)[0]
    logits = model(local.context, local.examples, local.mask, training=False)
    # One shared sort per (scores, mask) across the metric suite, plus
    # NDCG's ideal sorts; results are identical to unshared sorts.
    with list_ops.shared_sort_scope():
      out = {}
      for name, fn in metric_fns.items():
        task_logits, task_labels = _task_inputs(name, local, logits)
        values, weights = fn(task_labels, task_logits,
                             features=local.features)
        if num_valid_rows is not None:
          rows = (torch.arange(weights.shape[0], device=device)
                  + first_row) < num_valid_rows
          weights = weights * rows.reshape(
              (-1,) + (1,) * (weights.ndim - 1)).to(weights.dtype)
        out[name] = metric_states[name].update(values, weights)
    logits = _gather_rows(logits, mesh)
    if total_loss is not None:
      loss = total_loss(batch.labels, logits, batch.features, None)
      # Weight by the batch's valid-list count so a ragged final batch
      # contributes proportionally; an all-padding batch gets weight 0 and
      # a zeroed value (its loss over no list is typically NaN).
      n_lists = torch.sum(torch.any(batch.mask, dim=-1).to(torch.float32))
      loss = torch.where(n_lists > 0, loss, 0.0)
      if mesh.data_index:
        n_lists = torch.zeros_like(n_lists)   # one rank streams it
        loss = torch.zeros_like(loss)
      out['loss'] = metric_states['loss'].update(loss[None], n_lists[None])
    return out, logits

  return eval_step


class GraphedEvalStep:
  """The eval step on CUDA as one CUDA graph for each batch signature.

  The eval counterpart of ``GraphedSteps``, and of the JAX package's one
  jitted eval step. ``__call__`` has the eval step's signature and
  results. The first call with a batch signature (names, shapes, dtypes)
  runs the eager step on a side stream, as capture requires; the next one
  captures the step, reading static copies of the batch, of
  ``num_valid_rows`` (a device scalar: a Python int would be frozen into
  the graph; None is the batch size, which weighs every row by 1, bit for
  bit the unmasked weights) and of the metric states, and every later one
  copies its batch into those buffers and replays the graph. Every
  distinct signature is captured once (bucketed list sizes give one graph
  a bucket, as jit compiles once a shape); ``captures`` counts them. The
  graphs are bound to the model's parameters and buffers where they lie:
  another model, or a tensor of it that moved, drops them and their memory
  pool.

  The graph reads and writes the metric states in its own buffer, in
  place: each call copies the states it is given into the buffer, and
  returns a copy of the buffer after the replay, so that what a caller
  holds is never overwritten. The logits come back as a copy too (a dict
  of copies for a multi-task model, whose labels are a dict as well).
  Replays equal the eager step bit for bit.

  The kernel wrappers count their launches where they run, and in a graph
  that is once, at capture: ``captured_launches()`` sums what the captures
  recorded, ``replayed_launches()`` what the replays ran (each graph's
  captured launches times its replays), so that launches on the card =
  wrapper counts - captured + replayed. A failed capture raises.

  On the CPU the eager step runs.
  """

  def __init__(self, eval_step: Callable[..., Tuple[Dict[str, MeanState],
                                                   Any]],
               device: DeviceLike = 'cuda'):
    self.eval_step = eval_step
    self.device = resolve_device(device)
    self.graphs: Dict[tuple, Dict[str, Any]] = {}
    self.captures = 0
    self.replays = 0
    self._warm = set()
    # The model and the addresses of its tensors that the graphs read; the
    # model is held so that its id is not reused.
    self._model = self._addresses = None
    self._pool = None   # one memory pool for all the live graphs

  def _capture(self, model, batch: RankingBatch, metric_states):
    names = list(metric_states)
    entry = {
        'names': names,
        'batch': _clone(batch),
        'rows': torch.zeros((), dtype=torch.int64, device=self.device),
        'buf': torch.zeros((len(names), 2), dtype=torch.float32,
                           device=self.device),
        'replays': 0}
    buf = entry['buf']
    static_states = {n: MeanState(buf[i, 0], buf[i, 1])
                     for i, n in enumerate(names)}
    graph = torch.cuda.CUDAGraph()
    before = kernel_launch_counts()
    try:
      with torch.cuda.graph(graph, pool=self._pool):
        out, logits = self.eval_step(model, entry['batch'], static_states,
                                     num_valid_rows=entry['rows'])
        buf.copy_(torch.stack(
            (torch.stack([out[n].total for n in names]),
             torch.stack([out[n].count for n in names])), dim=1))
    except Exception as e:
      raise RuntimeError(
          f'capturing the eval step in a CUDA graph failed: {e}') from e
    after = kernel_launch_counts()
    entry['captured_launches'] = {n: after[n] - before[n] for n in after
                                  if after[n] != before[n]}
    entry['graph'], entry['logits'] = graph, logits
    if self._pool is None:
      self._pool = graph.pool()
    self.captures += 1
    return entry

  def __call__(self, model, batch: RankingBatch,
               metric_states: Dict[str, MeanState],
               num_valid_rows: Optional[int] = None):
    if self.device.type != 'cuda':
      return self.eval_step(model, batch, metric_states,
                            num_valid_rows=num_valid_rows)
    addresses = tuple(t.data_ptr() for t in itertools.chain(
        model.parameters(), model.buffers()))
    if model is not self._model or addresses != self._addresses:
      self.graphs, self._warm, self._pool = {}, set(), None
      self._model, self._addresses = model, addresses
    batch = batch.to(self.device)
    key = (_signature(batch), tuple(metric_states))
    entry = self.graphs.get(key)
    if entry is None and key not in self._warm:
      side = torch.cuda.Stream()
      side.wait_stream(torch.cuda.current_stream())
      with torch.cuda.stream(side):
        out = self.eval_step(model, batch, metric_states,
                             num_valid_rows=num_valid_rows)
      torch.cuda.current_stream().wait_stream(side)
      self._warm.add(key)
      return out
    if entry is None:
      entry = self.graphs[key] = self._capture(model, batch, metric_states)
    for dst, src in zip(_leaves(entry['batch']), _leaves(batch)):
      dst.copy_(src)
    entry['rows'].fill_(batch.batch_size if num_valid_rows is None
                        else num_valid_rows)
    names, buf = entry['names'], entry['buf']
    buf.copy_(torch.stack(
        (torch.stack([metric_states[n].total for n in names]),
         torch.stack([metric_states[n].count for n in names])), dim=1))
    entry['graph'].replay()
    entry['replays'] += 1
    self.replays += 1
    held = buf.clone()
    logits = entry['logits']
    return ({n: MeanState(held[i, 0], held[i, 1])
             for i, n in enumerate(names)},
            ({k: v.clone() for k, v in logits.items()}
             if isinstance(logits, Mapping) else logits.clone()))

  def captured_launches(self) -> Dict[str, int]:
    """What the captures recorded, by wrapper name, over all graphs."""
    out: Dict[str, int] = {}
    for entry in self.graphs.values():
      for n, c in entry['captured_launches'].items():
        out[n] = out.get(n, 0) + c
    return out

  def replayed_launches(self) -> Dict[str, int]:
    """What the replays launched on the card, by wrapper name."""
    out: Dict[str, int] = {}
    for entry in self.graphs.values():
      for n, c in entry['captured_launches'].items():
        out[n] = out.get(n, 0) + c * entry['replays']
    return out


def init_metric_states(metric_fns: Mapping[str, MetricFn],
                       with_loss: bool = False,
                       device: DeviceLike = 'cuda') -> Dict[str, MeanState]:
  device = resolve_device(device)
  states = {name: MeanState.zero(device) for name in metric_fns}
  if with_loss:
    states['loss'] = MeanState.zero(device)
  return states


def metric_results(metric_states: Mapping[str, MeanState],
                   mesh: Optional[mesh_lib.Mesh] = None) -> Dict[str, Tensor]:
  """Each state's mean; with ``mesh``, of the states summed over the data
  group (a collective: every rank calls it)."""
  if mesh is not None and mesh.data_group is not None and metric_states:
    names = list(metric_states)
    sums = comm.all_reduce(torch.stack(
        [torch.stack((metric_states[n].total, metric_states[n].count))
         for n in names]), mesh.data_group)
    metric_states = {n: MeanState(sums[i, 0], sums[i, 1])
                     for i, n in enumerate(names)}
  return {name: s.result() for name, s in metric_states.items()}
