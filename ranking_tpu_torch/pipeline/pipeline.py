"""End-to-end train-and-validate pipelines.

The port's copy of ``ranking_tpu/pipeline/pipeline.py``:
``SimpleDatasetBuilder`` (serialized protos in TFRecord files, through the
C++ streaming loader or the Python stream), ``LibSVMDatasetBuilder``,
``SimplePipeline.train_and_validate`` and ``RankingPipeline``. The
pipeline owns the train state, the train step (K steps per dispatch, on
CUDA as replays of one captured graph), the eval loop, checkpoint and
resume, the plateau learning rate, early stopping, best tracking, the
metrics log, TensorBoard scalars and the latest and best exports. On
CUDA the eval step is one captured graph a batch shape.

It takes an ``nn.Module`` that already holds its weights: the port has no
``init(rng)``, so a run that should start from the JAX package's weights
converts them first (``convert.from_flax``).

Over several processes (``torchrun``, ``parallel.init_distributed``) the
pipeline lays a ``(data, model)`` mesh over the ranks (``parallel/``), as
the JAX package lays one over its devices: every rank reads the global
stream with the same seed and the steps give each rank its rows
(``train/steps.py``), so that a run's result does not depend on the mesh;
``sharding_rules`` split the parameters that they name over the model
group. Eval pads a ragged batch to the data axis's multiple, and the
metric states are summed over the data group. The first rank alone writes
checkpoints, event logs and exports, of the whole state. Under gloo with
CUDA tensors the steps dispatch eagerly (gloo's collectives cannot be
captured in a CUDA graph).
A dataset builder is any object with ``train_batches()`` and
``valid_batches()`` iterators of ``RankingBatch``; one whose
``train_batches`` takes ``skip_batches`` resumes without parsing the
batches it skips. ``MultiLabelDatasetBuilder`` gives dict labels, one a
task, and ``MultiTaskPipeline`` trains a dict of task losses (a
``SimplePipeline`` does too, given a dict ``hparams.loss``) with
``task/metric`` names scored per task.
"""

from __future__ import annotations

import contextlib
import inspect
import itertools
import math
import os
import time
from typing import Any, Callable, Dict, Iterator, Mapping, Optional

import torch
from torch import nn

from ranking_tpu_torch.data import dataset
from ranking_tpu_torch.data.batch import RankingBatch, stack_numpy_batches
from ranking_tpu_torch.ops import loss_registry, metric_registry
from ranking_tpu_torch.ops.reductions import Reduction
from ranking_tpu_torch.parallel import mesh as mesh_lib
from ranking_tpu_torch.pipeline.hparams import (
    DatasetHparams, PipelineHparams, optimizer_from_hparams,
    sparse_optimizer_from_hparams)
from ranking_tpu_torch.train import checkpoint
from ranking_tpu_torch.train import sparse as sparse_lib
from ranking_tpu_torch.train import state as state_lib
from ranking_tpu_torch.train import steps
from ranking_tpu_torch.utils import profiling
from ranking_tpu_torch.utils import tensorboard
from ranking_tpu_torch.utils.device import DeviceLike, resolve_device


_ENGINES = ('auto', 'native_loader', 'python')


class SimpleDatasetBuilder:
  """TFRecord-backed dataset builder (keras/pipeline.py:1026-1117).

  ``hparams.dataset_engine`` picks the stream of each split: 'native_loader'
  (``dataset.native_ranking_dataset``, the C++ loader, with the
  decoded-once cache at ``dataset_cache``), 'python'
  (``dataset.build_ranking_dataset``), or 'auto', which takes the loader
  wherever ``native.loader_supported`` accepts the specs, format and list
  size. ``engine`` holds what each split resolved to, and ``loader`` the
  decode threads and cache state ('off', 'build' or 'read') of each
  split's newest native stream. An engine asked for by name is taken: the
  loader raises for specs it does not serve, and for a ``dataset_cache``
  it cannot open or lock, and nothing falls back. The train stream
  repeats and drops its partial batch; the validation stream is one pass
  that keeps it (python/data.py:1008).
  """

  def __init__(self, context_feature_spec, example_feature_spec,
               hparams: DatasetHparams, seed: Optional[int] = None,
               label_feature_name=None):
    from ranking_tpu_torch.data import native
    self.context_feature_spec = dict(context_feature_spec)
    self.example_feature_spec = dict(example_feature_spec)
    self.hparams = hparams
    self.seed = seed
    self.label_feature_name = (
        hparams.label_feature_name if label_feature_name is None
        else label_feature_name)
    if hparams.dataset_engine not in _ENGINES:
      raise ValueError(f'dataset_engine {hparams.dataset_engine!r}; one of '
                       f'{_ENGINES}')
    self.engine = {}
    self.loader = {}
    for split, list_size in (('train', hparams.list_size),
                             ('valid', self._valid_list_size)):
      engine = hparams.dataset_engine
      if engine == 'auto':
        engine = ('native_loader' if native.loader_supported(
            self.context_feature_spec, self.example_feature_spec,
            hparams.dataset_reader, list_size) else 'python')
      self.engine[split] = engine
    if hparams.dataset_cache is not None and 'python' in self.engine.values():
      raise ValueError(
          f'dataset_cache is set, but a split resolved to the python stream '
          f'({self.engine}); the decoded-once cache lives in the native '
          'loader')

  @property
  def _valid_list_size(self) -> Optional[int]:
    return self.hparams.valid_list_size or self.hparams.list_size

  def _batches(self, split, pattern, batch_size, list_size, shuffle, epochs,
               skip_batches=0) -> Iterator[RankingBatch]:
    hp = self.hparams
    common = dict(
        data_format=hp.dataset_reader, batch_size=batch_size,
        context_feature_spec=self.context_feature_spec,
        example_feature_spec=self.example_feature_spec,
        label_feature_name=self.label_feature_name, list_size=list_size,
        convert_labels_to_binary=hp.convert_labels_to_binary,
        epochs=epochs, shuffle=shuffle,
        shuffle_buffer_size=hp.shuffle_buffer_size,
        mask_feature_name=hp.mask_feature_name,
        size_feature_name=hp.size_feature_name,
        drop_remainder=epochs is None, skip_batches=skip_batches,
        seed=self.seed)
    if self.engine[split] == 'native_loader':
      stream = dataset.native_ranking_dataset(
          pattern, cache_dir=hp.dataset_cache, **common)
      self.loader[split] = {'threads': stream.loader.num_threads,
                            'cache': stream.loader.cache_state}
      return stream
    return dataset.build_ranking_dataset(
        pattern, interleave_files=hp.interleave_files, **common)

  def train_batches(self, skip_batches: int = 0) -> Iterator[RankingBatch]:
    """The repeating, shuffled train stream. ``skip_batches`` drops its
    leading batches unparsed (resume): the stream goes on bitwise as the
    unskipped one after as many batches."""
    return self._batches('train', self.hparams.train_input_pattern,
                         self.hparams.train_batch_size,
                         self.hparams.list_size, shuffle=True, epochs=None,
                         skip_batches=skip_batches)

  def valid_batches(self) -> Iterator[RankingBatch]:
    return self._batches('valid', self.hparams.valid_input_pattern,
                         self.hparams.valid_batch_size,
                         self._valid_list_size, shuffle=False, epochs=1)


class MultiLabelDatasetBuilder(SimpleDatasetBuilder):
  """Dict-label dataset builder for multi-task training
  (keras/pipeline.py:1120-1221).

  ``label_spec`` maps task names to example label feature names; each is
  parsed, padded with -1 and popped into ``batch.labels[task]``, ready for
  ``MultiTaskPipeline``'s dict losses. The label features must be in
  ``example_feature_spec``.
  """

  def __init__(self, context_feature_spec, example_feature_spec,
               label_spec: Mapping[str, str], hparams: DatasetHparams,
               seed: Optional[int] = None):
    if not label_spec:
      raise ValueError('label_spec must map at least one task to a label '
                       'feature name.')
    missing = [name for name in label_spec.values()
               if name not in example_feature_spec]
    if missing:
      raise ValueError(
          f'label features {missing} missing from example_feature_spec.')
    super().__init__(context_feature_spec, example_feature_spec, hparams,
                     seed=seed, label_feature_name=dict(label_spec))


class LibSVMDatasetBuilder:
  """In-memory LIBSVM dataset builder for the pipelines.

  Both files are parsed once, by the native parser; the train stream
  repeats forever, shuffled from ``seed``, and the validation stream is one
  pass that keeps its ragged final batch.
  """

  def __init__(self, train_path: str, valid_path: str, list_size: int,
               num_features: int, train_batch_size: int,
               valid_batch_size: Optional[int] = None,
               seed: Optional[int] = 17):
    from ranking_tpu_torch.data import libsvm
    self.train_x, self.train_y, _ = libsvm.load_libsvm_lists(
        train_path, list_size, num_features)
    self.valid_x, self.valid_y, _ = libsvm.load_libsvm_lists(
        valid_path, list_size, num_features)
    self.train_batch_size = train_batch_size
    self.valid_batch_size = valid_batch_size or train_batch_size
    self.seed = seed

  def train_batches(self) -> Iterator[RankingBatch]:
    return dataset.in_memory_batches(self.train_x, self.train_y,
                                     self.train_batch_size, epochs=None,
                                     shuffle=True, seed=self.seed)

  def valid_batches(self) -> Iterator[RankingBatch]:
    return dataset.in_memory_batches(self.valid_x, self.valid_y,
                                     self.valid_batch_size, epochs=1,
                                     shuffle=False, drop_remainder=False)


class SimplePipeline:
  """Single-task pipeline with the reference's default metric suite:
  NDCG@1/5/10 and full-list NDCG (keras/pipeline.py:659-730).

  A dict ``hparams.loss`` (``{task: loss_key}``) trains a multi-task
  model, each task's loss weighted by a dict ``hparams.loss_weights``
  (default 1), in the train step and in the validation loss alike.
  ``device`` (default ``'cuda'``; without a card it raises) is where the
  model, its optimizers and every step live. ``mesh`` (every rank's own,
  from ``parallel.make_mesh``) or, without one, ``hparams.mesh_data`` and
  ``mesh_model`` over the ranks of the process group lay out the run; with
  no process group and no mesh the pipeline runs on one card, without
  collectives. ``sharding_rules`` (``parallel.DEFAULT_RULES``, or
  ``ENCODER_TP_RULES`` for the tensor-parallel encoder) split parameters
  over the model axis.
  """

  def __init__(
      self,
      model: nn.Module,
      dataset_builder: Any,
      hparams: PipelineHparams,
      metric_fns: Optional[Mapping[str, Callable]] = None,
      loss_fn: Optional[Callable] = None,
      device: DeviceLike = 'cuda',
      mesh: Optional[mesh_lib.Mesh] = None,
      sharding_rules=mesh_lib.DEFAULT_RULES,
  ):
    self.device = resolve_device(device)
    self._given_mesh = mesh
    self.mesh: Optional[mesh_lib.Mesh] = None
    self._sharding_rules = sharding_rules
    self.model = model
    self.dataset_builder = dataset_builder
    self.hparams = hparams
    self.metric_fns = dict(metric_fns) if metric_fns else (
        self._default_metrics())
    loss_kwargs = dict(reduction=Reduction(hparams.loss_reduction),
                       weights_feature_name=hparams.weights_feature_name)
    if loss_fn is not None:
      self.loss_fn = loss_fn
    elif isinstance(hparams.loss, Mapping):
      self.loss_fn = {task: loss_registry.make_loss_fn(key, **loss_kwargs)
                      for task, key in hparams.loss.items()}
    else:
      self.loss_fn = loss_registry.make_loss_fn(hparams.loss, **loss_kwargs)
      if isinstance(hparams.loss_weights, (int, float)):
        # A scalar loss_weights scales the single loss.
        base_fn, w = self.loss_fn, float(hparams.loss_weights)
        self.loss_fn = lambda *a, **kw: w * base_fn(*a, **kw)
    self.final_state: Optional[state_lib.TrainState] = None

  def _default_metrics(self):
    hp = self.hparams
    weighted = (hp.weights_feature_name
                if hp.use_weighted_metrics else None)
    fns = {}
    for topn in (1, 5, 10, None):
      name = f'ndcg@{topn}' if topn else 'ndcg'
      fns[name] = metric_registry.make_ranking_metric_fn(
          metric_registry.RankingMetricKey.NDCG, topn=topn)
      if weighted:
        fns[f'weighted_{name}'] = metric_registry.make_ranking_metric_fn(
            metric_registry.RankingMetricKey.NDCG, topn=topn,
            weights_feature_name=weighted)
    return fns

  @property
  def _task_weights(self) -> Optional[Mapping[str, float]]:
    """A dict ``loss_weights``: the tasks' weights in the total loss."""
    weights = self.hparams.loss_weights
    return weights if isinstance(weights, Mapping) else None

  # -- build ---------------------------------------------------------------

  def _make_mesh(self, sample: RankingBatch) -> Optional[mesh_lib.Mesh]:
    """The given mesh; else one over the process group's ranks where there
    is a group or the hparams ask for more than one rank; else None."""
    if self._given_mesh is not None:
      return self._given_mesh
    import torch.distributed as dist
    hp = self.hparams
    up = dist.is_available() and dist.is_initialized()
    if not up and hp.mesh_model == 1 and hp.mesh_data in (None, 1):
      return None
    data = hp.mesh_data
    if data is None:
      world = dist.get_world_size() if up else 1
      data = mesh_lib.default_data_size(sample.batch_size, world,
                                        hp.mesh_model)
    return mesh_lib.make_mesh(data=data, model=hp.mesh_model)

  @property
  def _writer(self) -> bool:
    """Whether this rank writes the run's files."""
    return self.mesh is None or self.mesh.rank == 0

  def _build(self, sample: RankingBatch) -> state_lib.TrainState:
    hp = self.hparams
    self.mesh = mesh = self._make_mesh(sample)
    if mesh is not None:
      mesh_lib.shard_module(self.model, mesh, self._sharding_rules)
    sparse_tx = sparse_optimizer_from_hparams(hp)
    state = state_lib.create_train_state(
        self.model, optimizer_from_hparams(hp), device=self.device,
        sparse_tx=sparse_tx)
    state.generator = torch.Generator(self.device).manual_seed(
        (hp.seed or 0) + 1)
    # The reference monitors the validation stream: 'val_' + metric, with
    # metric 'loss' meaning the validation loss (keras/pipeline.py:497-532).
    self._monitor = ('val_loss' if hp.best_exporter_metric == 'loss'
                     else hp.best_exporter_metric)
    if self._monitor != 'val_loss' and self._monitor not in self.metric_fns:
      raise ValueError(
          f'best_exporter_metric {hp.best_exporter_metric!r} is not among '
          f'the computed validation metrics: '
          f'{sorted(self.metric_fns) + ["loss"]}')
    self.ckpt = checkpoint.CheckpointManager(
        os.path.join(hp.model_dir, 'checkpoints'),
        best_metric=(self._monitor if hp.export_best_model else None),
        best_mode=('max' if hp.best_exporter_metric_higher_better else 'min'),
        mesh=mesh)
    state = self.ckpt.restore(state)  # preemption-safe resume
    self._tb = (tensorboard.SummaryWriter(
        os.path.join(hp.model_dir, 'tensorboard')) if self._writer else None)
    step_fn = None
    if sparse_tx is not None:
      # The sparse step wherever the model's naming ties every lazy table
      # to a batch feature; otherwise the plain step, whose tables' dense
      # gradients still get the lazy-row update (sparse_tx.update).
      efs = sparse_lib.derive_embed_features(
          sparse_lib.named_paths(state.model), sample.context,
          sample.examples, table_pattern=sparse_tx.table_pattern)
      tables = set(sparse_lib.partition(sparse_lib.named_paths(state.model),
                                        sparse_tx)[1])
      if efs and {ef.param_path for ef in efs} == tables:
        step_fn = steps.make_sparse_train_step(
            self.loss_fn, efs, multi_task_weights=self._task_weights,
            device=self.device, mesh=mesh)
    if step_fn is None:
      step_fn = steps.make_train_step(
          self.loss_fn, multi_task_weights=self._task_weights,
          device=self.device, mesh=mesh)
    self._train_step = step_fn
    eager = (mesh is not None and mesh.size > 1 and mesh.backend == 'gloo'
             and self.device.type == 'cuda')
    if eager:
      import warnings
      warnings.warn('gloo collectives cannot be captured in a CUDA graph: '
                    'the train and eval steps dispatch eagerly')
    # steps_per_execution (keras/pipeline.py:287-289): K steps a dispatch.
    self._multi_step = steps.make_multi_step(step_fn, device=self.device,
                                             eager=eager)
    # On CUDA one captured eval step a batch shape, kept across the
    # epochs of the run.
    eval_step = steps.make_eval_step(self.metric_fns, loss_fn=self.loss_fn,
                                     multi_task_weights=self._task_weights,
                                     device=self.device, mesh=mesh)
    self._eval_step = (eval_step if eager
                       else steps.GraphedEvalStep(eval_step, self.device))
    return state

  # -- loops ---------------------------------------------------------------

  def _valid_batches(self) -> Iterator[RankingBatch]:
    """The validation stream, each ragged batch padded with fully masked
    rows to the data axis's multiple, beside its real row count."""
    n_data = 1 if self.mesh is None else self.mesh.data
    for batch in self.dataset_builder.valid_batches():
      n_real = batch.batch_size
      if n_real % n_data:
        batch = batch.pad_to(-(-n_real // n_data) * n_data)
      yield batch, n_real

  def _run_eval(self, state: state_lib.TrainState) -> Dict[str, float]:
    """One pass over the validation stream (at most ``validation_steps``
    batches), through the graphed eval step on CUDA. Every batch passes
    its real row count as ``num_valid_rows``, which gives the rows that pad
    a ragged batch to the data axis's multiple metric weight 0. The
    streamed loss is ``val_loss``."""
    states = steps.init_metric_states(self.metric_fns, with_loss=True,
                                      device=self.device)
    pairs = self._valid_batches()
    counts = []

    def batches():
      for batch, n_real in pairs:
        counts.append(n_real)
        yield batch

    feed = dataset.prefetch_to_device(batches(), self.device,
                                      flat_examples=True)
    for n, batch in enumerate(feed, start=1):
      states, _ = self._eval_step(state.model, batch, states,
                                  num_valid_rows=counts[n - 1])
      if n >= self.hparams.validation_steps:
        break
    results = steps.metric_results(states, self.mesh)
    values = torch.stack([v.to(torch.float32) for v in results.values()])
    out = dict(zip(results, values.cpu().tolist()))
    out['val_loss'] = out.pop('loss')
    return out

  def _dispatches(self, batches: Iterator[RankingBatch], step: int,
                  total_steps: int, spe: int) -> Iterator[RankingBatch]:
    """The host side of each dispatch the loop will make from ``step``: one
    flat batch, or with ``spe`` > 1 the next chunk of flat batches stacked
    (in page-locked memory on CUDA) on a leading steps axis; a chunk ends
    at an epoch's end."""
    per_epoch = self.hparams.steps_per_epoch
    pin = self.device.type == 'cuda'
    while step < total_steps:
      epoch_end = min(total_steps, (step // per_epoch + 1) * per_epoch)
      chunk = min(spe, epoch_end - step)
      flat = [dataset.flatten_examples(next(batches)) for _ in range(chunk)]
      yield (stack_numpy_batches(flat, pin_memory=pin) if spe > 1
             else flat[0])
      step += chunk

  def _resumed_stream(self, raw_iter, first, step: int):
    """The train stream, fast-forwarded by ``step`` batches when resuming
    with ``resume_dataset``: by the builder's own ``skip_batches`` where
    its ``train_batches`` takes one (no parse of the skipped batches),
    else pulled and dropped."""
    base_iter = itertools.chain([first], raw_iter)
    if not (self.hparams.resume_dataset and step > 0):
      return base_iter
    if (hasattr(self.dataset_builder, 'seed')
        and self.dataset_builder.seed is None):
      raise ValueError(
          'resume_dataset=True requires a seeded dataset builder '
          '(seed=None re-shuffles differently on every construction, '
          'so the fast-forwarded stream would not match the '
          'interrupted run); pass an explicit seed to the builder')
    if 'skip_batches' in inspect.signature(
        self.dataset_builder.train_batches).parameters:
      if hasattr(raw_iter, 'close'):
        raw_iter.close()  # releases a loader's threads and buffers
      return iter(self.dataset_builder.train_batches(skip_batches=step))
    for _ in range(step):
      next(base_iter)
    return base_iter

  def _steps_per_dispatch(self) -> int:
    """``steps_per_execution``, and 1 for bucketed list sizes on the CPU:
    consecutive batches may then have other shapes, which one stack of K
    batches cannot hold. On CUDA a graph replays one shape, so bucketed
    batches under K > 1 raise there instead of stepping eagerly."""
    spe = max(1, int(self.hparams.steps_per_execution))
    ds_hp = getattr(self.dataset_builder, 'hparams', None)
    if spe > 1 and ds_hp is not None and getattr(ds_hp, 'list_size',
                                                 0) is None:
      if self.device.type == 'cuda':
        raise ValueError(
            f'steps_per_execution={spe} with list_size=None (bucketed list '
            'sizes): a CUDA graph replays one batch shape; set list_size '
            'or steps_per_execution=1')
      spe = 1
    return spe

  def train_and_validate(self, verbose: bool = False) -> Dict[str, float]:
    hp = self.hparams
    spe = self._steps_per_dispatch()
    raw_iter = iter(self.dataset_builder.train_batches())
    first = next(raw_iter)  # the state's sparse features come from data
    state = self._build(first)
    if self.mesh is not None and not self.mesh.member:
      return {}   # a rank past the mesh idles (default_data_size warned)
    start_step = int(state.step)
    step = start_step
    total_steps = hp.num_epochs * hp.steps_per_epoch
    feed = dataset.prefetch_to_device(
        self._dispatches(self._resumed_stream(raw_iter, first, start_step),
                         step, total_steps, spe), self.device)

    best = -math.inf if hp.best_exporter_metric_higher_better else math.inf
    patience_left = hp.early_stopping_patience
    # ReduceLROnPlateau (keras defaults: factor 0.1, patience 10, min_delta
    # 0.01 * lr; keras/pipeline.py:512-517) on the validation loss.
    plateau_best = math.inf
    plateau_wait = 0
    history: Dict[str, float] = {}
    t0 = time.perf_counter()
    lists_seen = 0
    while step < total_steps:
      epoch_index = step // hp.steps_per_epoch + 1
      epoch_end = min(total_steps, epoch_index * hp.steps_per_epoch)
      traced = contextlib.nullcontext()
      if hp.profile_dir is not None and epoch_index == hp.profile_epoch:
        traced = profiling.trace(hp.profile_dir, self.device,
                                 f'trace_epoch{epoch_index}.json')
      losses = []  # on the device; read once an epoch
      with traced:
        while step < epoch_end:
          batch = next(feed)
          if spe > 1:
            state, metrics = self._multi_step(state, batch, state.generator)
            chunk = batch.mask.shape[0]
            lists_seen += chunk * batch.mask.shape[1]
          else:
            state, metrics = self._train_step(state, batch, state.generator)
            chunk = 1
            lists_seen += batch.batch_size
          losses.append(metrics['loss'].reshape(-1))
          step += chunk
      epoch_metrics = self._run_eval(state)
      epoch_metrics['loss'] = torch.cat(losses).to(torch.float32).mean(
          ).item()
      dt = time.perf_counter() - t0
      epoch_metrics['examples_per_sec'] = lists_seen / dt if dt else 0.0
      if self._writer:
        checkpoint.write_metrics_log(hp.model_dir, step, epoch_metrics)
        self._tb.scalars(step, epoch_metrics)
        self._tb.flush()
      self.ckpt.save(state, metrics=epoch_metrics)
      history = epoch_metrics
      if verbose:
        print(f'step {step}: ' + ', '.join(
            f'{k}={v:.4f}' for k, v in epoch_metrics.items()))

      if hp.automatic_reduce_lr:
        if epoch_metrics['val_loss'] < plateau_best - 0.01 * hp.learning_rate:
          plateau_best = epoch_metrics['val_loss']
          plateau_wait = 0
        else:
          plateau_wait += 1
          if plateau_wait >= 10:
            plateau_wait = 0
            state.optimizer.lr.mul_(0.1)  # in place: the graph reads it

      # EarlyStopping / best tracking on the validation stream; a missing
      # metric name is an error, never a silent fallback.
      if self._monitor not in epoch_metrics:
        raise ValueError(
            f'best_exporter_metric {hp.best_exporter_metric!r} is not among '
            f'the computed validation metrics: {sorted(epoch_metrics)}')
      current = epoch_metrics[self._monitor]
      improved = (current > best + hp.early_stopping_min_delta
                  if hp.best_exporter_metric_higher_better
                  else current < best - hp.early_stopping_min_delta)
      if improved:
        best = current
        patience_left = hp.early_stopping_patience
      elif hp.early_stopping_patience:
        patience_left -= 1
        if patience_left <= 0:
          break

    if self._tb is not None:
      self._tb.close()
    # Export latest, and (the reference's latest_model /
    # best_model_by_metric pair, keras/pipeline.py:634-650) the best-by-
    # metric weights, which under early stopping are not the final ones.
    checkpoint.export_params(state,
                             os.path.join(hp.model_dir, 'export', 'latest'),
                             mesh=self.mesh)
    if hp.export_best_model:
      checkpoint.export_params(self.ckpt.restore_best(state),
                               os.path.join(hp.model_dir, 'export', 'best'),
                               mesh=self.mesh)
    self.final_state = state
    return history


class RankingPipeline(SimplePipeline):
  """Estimator-era API alias (extension/pipeline.py:32): same object,
  ``train_and_eval`` naming."""

  def train_and_eval(self, verbose: bool = False):
    return self.train_and_validate(verbose=verbose)


class MultiTaskPipeline(SimplePipeline):
  """Dict-loss pipeline (keras/pipeline.py:733-830): ``hparams.loss =
  {task: loss_key}``, optionally per-task ``loss_weights``; its default
  suite is NDCG@1/5/10 and full NDCG for each task, as ``task/ndcg@k``."""

  def _default_metrics(self):
    fns = {}
    for task in self.hparams.loss:
      for topn in (1, 5, 10, None):
        name = f'{task}/ndcg@{topn}' if topn else f'{task}/ndcg'
        fns[name] = metric_registry.make_ranking_metric_fn(
            metric_registry.RankingMetricKey.NDCG, topn=topn)
    return fns
