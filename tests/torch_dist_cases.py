"""The rank side of the port's distributed CPU tests.

``tests/test_torch_parallel.py`` and ``tests/test_torch_distributed.py``
compute the JAX package's single-device results on a global batch in the
pytest process, write the inputs with ``torch.save``, and start one gloo
worker a rank with ``torch.multiprocessing`` (``spawn``: every world size of a
test file at once). Each worker
brings up the process group through a ``file://`` rendezvous under the
test's temporary directory (no port to race for), runs every case it is
given on its own mesh, and writes what it computed, whole tensors gathered
where a case shards them. This module imports torch and the port only.
"""

import os
import traceback

import numpy as np
import torch


def _t(x):
  return torch.as_tensor(np.asarray(x))


def _np(x):
  return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _mesh(spec):
  from ranking_tpu_torch import parallel
  return parallel.make_mesh(data=spec[0], model=spec[1])


def _whole_state(model, mesh):
  from ranking_tpu_torch.parallel import mesh as mesh_lib
  sd = mesh_lib.gather_state_dict(model.state_dict(), model, mesh)
  return {k: _np(v) for k, v in sd.items()}


def _batch(x, labels, mask):
  from ranking_tpu_torch.data import batch as batch_lib
  from ranking_tpu_torch.data import dataset
  return dataset.flatten_examples(batch_lib.batch_from_labels(
      labels, examples={'x': x}, mask=mask))


# --------------------------------------------------------------- the roles


def case_roles(inp, mesh_spec):
  """Each collective role's forward and gradient over the data group: rank
  r of the group holds ``xs[r]``; ``cs`` and ``cg`` are the consumers."""
  from ranking_tpu_torch.parallel import comm
  mesh = _mesh(mesh_spec)
  g, r = mesh.data_group, mesh.data_index
  xs, cs, cg = _t(inp['xs']), _t(inp['cs']), _t(inp['cg'])
  out = {}

  def run(name, x, fn, consumer):
    x = x.clone().requires_grad_()
    y = fn(x)
    (y * consumer).sum().backward()
    out[name] = (_np(y), _np(x.grad))

  run('reduce', xs[r], lambda x: comm.reduce(x, g), cs[0])
  run('copy', xs[0], lambda x: comm.copy(x, g), cs[r])
  run('gather', xs[r], lambda x: comm.gather(x, g, 0), cg[r])
  run('gather_replicated', xs[r],
      lambda x: comm.gather_replicated(x, g, 0), cg[0])
  run('sum_over', xs[r], lambda x: comm.sum_over(x, g), cs[r])
  # The multi-host feed: each rank's rows back to the global batch.
  from ranking_tpu_torch import parallel
  from ranking_tpu_torch.data import batch as batch_lib
  whole = batch_lib.batch_from_labels(
      torch.arange(12.0).reshape(4, 3),
      context={'q': torch.arange(4)},
      examples={'x': torch.arange(24.0).reshape(12, 2)})
  back = parallel.local_batch_to_global(parallel.shard_batch(whole, mesh),
                                        mesh)
  out['feed'] = all(torch.equal(a, b) for a, b in (
      (back.labels, whole.labels), (back.mask, whole.mask),
      (back.context['q'], whole.context['q']),
      (back.examples['x'], whole.examples['x'])))
  return out


def case_fused_bn(inp, mesh_spec):
  """The fused tower's op (``fused_bn_mlp``, rows 2-5 through their plain
  versions here) on this rank's rows inside a data-parallel step: outputs,
  moments, the input's gradient and the parameters' (summed over the data
  group)."""
  from ranking_tpu_torch.ops.cuda import fused_bn
  from ranking_tpu_torch.parallel import comm
  mesh = _mesh(mesh_spec)
  lo, hi = mesh.row_block(inp['x'].shape[0])
  x = _t(inp['x'])[lo:hi].clone().requires_grad_()
  params = [[_t(p).clone().requires_grad_() for p in group]
            for group in inp['params']]
  with comm.active(mesh):
    out, means, vars_ = fused_bn.fused_bn_mlp(
        x, _t(inp['mask'])[lo:hi], *params)
    (out * _t(inp['cot'])[lo:hi]).sum().backward()
  return {'out': _np(out), 'means': [_np(m) for m in means],
          'vars': [_np(v) for v in vars_], 'dx': _np(x.grad),
          'grads': [[_np(comm.all_reduce(p.grad, mesh.data_group))
                     for p in group] for group in params]}


# ------------------------------------------------ lookup and pairwise loss


def case_lookup(inp, mesh_spec):
  from ranking_tpu_torch import parallel
  from ranking_tpu_torch.parallel import comm
  from ranking_tpu_torch.parallel import mesh as mesh_lib
  mesh = _mesh(mesh_spec)
  out = {}
  for combiner in ('mean', 'sum', 'sqrtn'):
    table = mesh_lib.local_slice(_t(inp['table']), 0, mesh).clone()
    table.requires_grad_()
    lo, hi = mesh.row_block(inp['ids'].shape[0])
    got = parallel.sharded_pooled_lookup(table, _t(inp['ids'])[lo:hi], mesh,
                                         combiner)
    (got * _t(inp['cot'])[lo:hi]).sum().backward()
    grad = comm.all_reduce(table.grad, mesh.data_group)
    out[combiner] = (_np(got), _np(grad))
  return out


def case_pairwise(inp, mesh_spec):
  from ranking_tpu_torch import parallel
  mesh = _mesh(mesh_spec)
  data_axis = 'data' if mesh.data > 1 else None
  out = {}
  lab, log, w = (_t(inp[k]) for k in ('labels', 'logits', 'weights'))
  b, l = lab.shape
  rows = slice(*mesh.row_block(b)) if data_axis else slice(0, b)
  n = l // mesh.model
  cols = slice(mesh.model_index * n, (mesh.model_index + 1) * n)
  for kind in ('logistic', 'hinge', 'soft_zero_one'):
    for red in ('sum', 'mean', 'sum_by_nonzero_weights'):
      x = log[rows, cols].clone().requires_grad_()
      loss = parallel.sharded_pairwise_loss(
          lab[rows, cols], x, mesh, axis='model', loss_kind=kind,
          weights=w[rows, cols], reduction=red, data_axis=data_axis)
      loss.backward()
      out[(kind, red)] = (_np(loss), _np(x.grad), (rows.start, cols.start))
  return out


# ------------------------------------------------------------ train steps


def _dnn_state(inp):
  from ranking_tpu_torch.models import scorers
  from ranking_tpu_torch.train import state as state_lib
  model = scorers.RankingModel(
      scorers.DNNScorer(tuple(inp['hidden']), in_features=inp['features'],
                        dropout=0.0, input_grad=False),
      transform_name='log1p')
  model.load_state_dict({k: _t(v) for k, v in inp['state'].items()})
  return state_lib.create_train_state(
      model, state_lib.adam(1e-3, eps=1e-3), device='cpu')


def case_dnn_step(inp, mesh_spec):
  """Train steps of the DNN scorer, fused plain path or unfused path."""
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.ops.cuda import fused_bn
  from ranking_tpu_torch.train import steps
  mesh = _mesh(mesh_spec)
  fused_bn.set_enabled(inp['fused'])
  try:
    state = _dnn_state(inp)
    step = steps.make_train_step(loss_registry.make_loss_fn(inp['loss']),
                                 device='cpu', mesh=mesh)
    metrics = []
    for x, labels, mask in inp['batches']:
      state, m = step(state, _batch(x, labels, mask))
      metrics.append({k: _np(v) for k, v in m.items()})
  finally:
    fused_bn.set_enabled(None)
  return {'metrics': metrics, 'state': _whole_state(state.model, mesh)}


def case_eval(inp, mesh_spec):
  """The eval step over the data group, each ragged batch padded to its
  multiple; the metric states summed over the group."""
  from ranking_tpu_torch.data import batch as batch_lib
  from ranking_tpu_torch.data import dataset
  from ranking_tpu_torch.ops import loss_registry, metric_registry
  from ranking_tpu_torch.train import steps
  mesh = _mesh(mesh_spec)
  state = _dnn_state(inp)
  fns = {f'{k}@{t}': metric_registry.make_ranking_metric_fn(k, topn=t)
         for k, t in inp['metrics']}
  step = steps.make_eval_step(fns, loss_fn=loss_registry.make_loss_fn(
      'softmax_loss'), device='cpu', mesh=mesh)
  states = steps.init_metric_states(fns, with_loss=True, device='cpu')
  logits = []
  for x, labels, mask in inp['batches']:
    n_real = labels.shape[0]
    batch = dataset.flatten_examples(batch_lib.batch_from_labels(
        labels, examples={'x': x}, mask=mask).pad_to(
            -(-n_real // mesh.data) * mesh.data))
    states, lg = step(state.model, batch, states, num_valid_rows=n_real)
    logits.append(_np(lg))
  results = steps.metric_results(states, mesh)
  return {'results': {k: _np(v) for k, v in results.items()},
          'logits': logits}


def case_sparse_step(inp, mesh_spec):
  """Steps of an EmbeddingDNNScorer whose tables are row-sharded over the
  model group: the sparse step, or with ``dense`` the plain step's
  dense-gradient lazy update; LazyAdam or LazyAdagrad."""
  from ranking_tpu_torch.data import batch as batch_lib
  from ranking_tpu_torch.data import dataset
  from ranking_tpu_torch.models import scorers
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.parallel import comm
  from ranking_tpu_torch.parallel import mesh as mesh_lib
  from ranking_tpu_torch.train import sparse
  from ranking_tpu_torch.train import state as state_lib
  from ranking_tpu_torch.train import steps
  mesh = _mesh(mesh_spec)
  model = scorers.RankingModel(scorers.EmbeddingDNNScorer(
      tuple(inp['hidden']), vocab_sizes=inp['vocab_sizes'],
      embedding_dim=inp['dim'], dropout=0.0, use_batch_norm=False,
      mesh=mesh))
  full = {k: _t(v) for k, v in inp['state'].items()}
  model.load_state_dict(mesh_lib.shard_state_dict(full, model, mesh))
  lr = inp['lr']
  if inp['kind'] == 'adam':
    dense_tx, sparse_tx = state_lib.adam(lr, eps=0.1), sparse.LazyAdam(lr)
  else:
    dense_tx, sparse_tx = state_lib.adagrad(lr), sparse.LazyAdagrad(lr)
  state = state_lib.create_train_state(model, dense_tx, device='cpu',
                                       sparse_tx=sparse_tx)
  efs = [sparse.EmbedFeature(**e) for e in inp['efs']]
  loss_fn = loss_registry.make_loss_fn('softmax_loss')
  if inp['dense']:   # the dense-gradient lazy update
    step = steps.make_train_step(loss_fn, device='cpu', mesh=mesh)
  else:
    step = steps.make_sparse_train_step(loss_fn, efs, device='cpu',
                                        mesh=mesh)
  metrics = []
  for labels, context, examples in inp['batches']:
    batch = dataset.flatten_examples(
        batch_lib.batch_from_labels(labels, context, examples))
    state, m = step(state, batch)
    metrics.append({k: _np(v) for k, v in m.items()})
  opt = {'count': _np(state.sparse_opt_state['count'])}
  for path in sorted({e.param_path for e in efs}):
    opt[path] = {k: _np(comm.all_gather(v, mesh.model_group, 0))
                 for k, v in state.sparse_opt_state[path].items()}
  local_rows = {n: p.shape[0] for n, p in model.named_parameters()
                if n in mesh_lib.sharded_dims(model)}
  return {'metrics': metrics, 'state': _whole_state(model, mesh),
          'opt': opt, 'local_rows': local_rows}


def case_tp_step(inp, mesh_spec):
  """One train step of the encoder scorer under ENCODER_TP_RULES, plain and
  with remat."""
  from ranking_tpu_torch import parallel
  from ranking_tpu_torch.data import batch as batch_lib
  from ranking_tpu_torch.data import dataset
  from ranking_tpu_torch.models import encoder as enc
  from ranking_tpu_torch.models import scorers
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.parallel import mesh as mesh_lib
  from ranking_tpu_torch.train import state as state_lib
  from ranking_tpu_torch.train import steps
  mesh = _mesh(mesh_spec)
  labels, ids = inp['labels'], inp['input_ids']
  batch = dataset.flatten_examples(batch_lib.batch_from_labels(
      labels, examples={'input_ids': ids}))

  def run(remat=False, on_mesh=True, clip=None):
    model = scorers.RankingModel(enc.EncoderScorer(
        enc.TransformerEncoder(**inp['config'], remat=remat), dropout=0.0))
    model.load_state_dict({k: _t(v) for k, v in inp['state'].items()})
    if on_mesh:
      parallel.shard_module(model, mesh, parallel.ENCODER_TP_RULES)
    state = state_lib.create_train_state(
        model, state_lib.adam(1e-2, eps=1e-3, clip_norm=clip), device='cpu')
    step = steps.make_train_step(loss_registry.make_loss_fn('softmax_loss'),
                                 device='cpu', mesh=mesh if on_mesh else None)
    state, m = step(state, batch)
    return {'loss': _np(m['loss']),
            'state': (_whole_state(model, mesh) if on_mesh else
                      {k: _np(v) for k, v in model.state_dict().items()}),
            'sharded': sorted(mesh_lib.sharded_dims(model))}

  # Global-norm clipping: the squares of model-sharded gradients are
  # summed over the model group; against one process's step on the same
  # batch, and the unclipped step to show that the clip bound.
  return {False: run(), True: run(remat=True),
          'clipped': run(clip=0.05),
          'clipped_one': run(on_mesh=False, clip=0.05)}


# --------------------------------------------------------------- pipeline


class TokenBuilder:
  """A dataset builder over token-id arrays: ``q`` context ids ``[N, T]``,
  ``d`` document ids ``[N, L, T]`` and labels ``[N, L]`` (-1 padding). The
  train stream repeats, shuffled from ``seed``; the validation stream is
  one pass over the first ``n_valid`` lists that keeps a ragged batch."""

  def __init__(self, arrays, batch_size, n_valid, seed=3):
    self.q, self.d, self.labels = arrays
    self.batch_size = batch_size
    self.n_valid = n_valid
    self.seed = seed

  def _batch(self, idx):
    from ranking_tpu_torch.data.batch import RankingBatch
    lab = torch.from_numpy(self.labels[idx])
    return RankingBatch(context={'q': torch.from_numpy(self.q[idx])},
                        examples={'d': torch.from_numpy(self.d[idx])},
                        labels=lab, mask=lab >= 0)

  def train_batches(self):
    rng = np.random.RandomState(self.seed)
    n = self.labels.shape[0]
    while True:
      order = rng.permutation(n)
      for start in range(0, n - self.batch_size + 1, self.batch_size):
        yield self._batch(order[start:start + self.batch_size])

  def valid_batches(self):
    for start in range(0, self.n_valid, self.batch_size):
      yield self._batch(np.arange(start, min(start + self.batch_size,
                                             self.n_valid)))


def pipeline_model(vocab, hidden, dim):
  from ranking_tpu_torch.models import scorers
  return scorers.RankingModel(scorers.EmbeddingDNNScorer(
      hidden, vocab_sizes={'q': vocab, 'd': vocab}, embedding_dim=dim,
      dropout=0.0, use_batch_norm=False,
      generator=torch.Generator().manual_seed(11)))


def pipeline_hparams(model_dir, mesh_model=1):
  from ranking_tpu_torch.pipeline import hparams
  return hparams.PipelineHparams(
      model_dir=model_dir, num_epochs=2, steps_per_epoch=3,
      validation_steps=3, learning_rate=0.05, loss='sigmoid_cross_entropy_loss',
      optimizer='lazy_adam', steps_per_execution=1, export_best_model=True,
      best_exporter_metric='ndcg@5', best_exporter_metric_higher_better=True,
      mesh_model=mesh_model)


def case_pipeline(inp, mesh_spec):
  """A 2-epoch pipeline whose mesh the hparams lay out (``mesh_model``),
  with the tables row-sharded by the default rules; then a pipeline that
  resumes from a one-card run's checkpoint and exports."""
  import torch.distributed as dist
  from ranking_tpu_torch.pipeline import pipeline
  from ranking_tpu_torch.parallel import mesh as mesh_lib
  cfg = inp['config']
  builder = TokenBuilder(inp['arrays'], cfg['batch'], cfg['n_valid'])
  model = pipeline_model(cfg['vocab'], tuple(cfg['hidden']), cfg['dim'])
  pipe = pipeline.SimplePipeline(
      model, builder, pipeline_hparams(inp['model_dir'], mesh_spec[1]),
      device='cpu')
  history = pipe.train_and_validate()
  sharded = sorted(mesh_lib.sharded_dims(pipe.final_state.model))
  mesh = pipe.mesh
  resumed = pipeline.SimplePipeline(
      pipeline_model(cfg['vocab'], tuple(cfg['hidden']), cfg['dim']),
      builder, pipeline_hparams(inp['resume_dir'], mesh_spec[1]),
      device='cpu')
  resumed.train_and_validate()
  dist.barrier()
  return {'history': history, 'sharded': sorted(sharded),
          'mesh': (mesh.data, mesh.model), 'resumed_step':
          resumed.final_state.step,
          'local_rows': {n: p.shape[0] for n, p in
                         pipe.final_state.model.named_parameters()
                         if n in mesh_lib.sharded_dims(pipe.final_state.model)}}


def case_pipeline_idle(inp, mesh_spec):
  """A pipeline on more ranks than the batch divides over: the hparams'
  default data axis takes the largest divisor, and the ranks past it
  idle."""
  import warnings
  from ranking_tpu_torch.pipeline import pipeline
  cfg = inp['config']
  pipe = pipeline.SimplePipeline(
      pipeline_model(cfg['vocab'], tuple(cfg['hidden']), cfg['dim']),
      TokenBuilder(inp['arrays'], cfg['batch'], cfg['n_valid']),
      pipeline_hparams(inp['model_dir']), device='cpu')
  with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter('always')
    history = pipe.train_and_validate()
  return {'history': history, 'member': pipe.mesh.member,
          'mesh': (pipe.mesh.data, pipe.mesh.model),
          'warned': any('idle' in str(w.message) for w in caught)}


def case_pipeline_tp(inp, mesh_spec):
  """``SimplePipeline(sharding_rules=ENCODER_TP_RULES)`` over an encoder
  scorer: the JAX package's ``test_pipeline_tensor_parallel_encoder``."""
  from ranking_tpu_torch import parallel
  from ranking_tpu_torch.models import encoder as enc
  from ranking_tpu_torch.models import scorers
  from ranking_tpu_torch.parallel import mesh as mesh_lib
  from ranking_tpu_torch.pipeline import pipeline
  cfg = inp['config']
  model = scorers.RankingModel(enc.EncoderScorer(
      enc.TransformerEncoder(vocab_size=cfg['vocab'], hidden_dim=8,
                             num_layers=1, num_heads=2, mlp_dim=16,
                             max_len=20, dropout=0.0,
                             generator=torch.Generator().manual_seed(5)),
      dropout=0.0, ids_feature_name='d'))
  pipe = pipeline.SimplePipeline(
      model, TokenBuilder(inp['arrays'], cfg['batch'], cfg['n_valid']),
      pipeline_hparams(inp['model_dir'], mesh_spec[1]), device='cpu',
      sharding_rules=parallel.ENCODER_TP_RULES)
  history = pipe.train_and_validate()
  return {'history': history,
          'sharded': sorted(mesh_lib.sharded_dims(pipe.final_state.model))}


CASES = {
    'roles': case_roles,
    'fused_bn': case_fused_bn,
    'lookup': case_lookup,
    'pairwise': case_pairwise,
    'dnn_fused': case_dnn_step,
    'dnn_unfused': case_dnn_step,
    'unique_softmax': case_dnn_step,
    'eval': case_eval,
    'sparse': case_sparse_step,
    'sparse_adagrad': case_sparse_step,
    'lazy_dense': case_sparse_step,
    'tp': case_tp_step,
    'pipeline': case_pipeline,
    'pipeline_tp': case_pipeline_tp,
    'pipeline_idle': case_pipeline_idle,
}


def run(rank, world, tmp):
  """One rank: the process group, every case of ``<tmp>/in.pt``, and its
  results (or the traceback of a failed case) in ``<tmp>/out_<rank>.pt``."""
  torch.set_num_threads(1)
  import torch.distributed as dist
  from ranking_tpu_torch import parallel
  parallel.init_distributed(
      'cpu', init_method=f'file://{os.path.join(tmp, "rendezvous")}',
      world_size=world, rank=rank)
  inputs = torch.load(os.path.join(tmp, 'in.pt'), weights_only=False)
  out = {}
  try:
    for name, (spec, inp) in inputs.items():
      try:
        out[name] = CASES[name](inp, spec)
      except Exception:  # reported by the test of this case
        out[name] = {'error': traceback.format_exc()}
  finally:
    torch.save(out, os.path.join(tmp, f'out_{rank}.pt'))
    dist.destroy_process_group()


def run_cli(rank, world, tmp, argv):
  """One rank of ``ranking_tpu_torch.examples.ranking_elwc_pipeline``, as
  ``torchrun`` would start it; then the live model's scores of the first
  validation batch, which every rank of a model group computes whole."""
  torch.set_num_threads(1)
  os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                    LOCAL_RANK=str(rank))
  import torch.distributed as dist
  from ranking_tpu_torch.examples import ranking_elwc_pipeline as cli
  pipe, history = cli.main(list(argv) + [
      f'--init_method=file://{os.path.join(tmp, "rendezvous")}'])
  batch = next(iter(pipe.dataset_builder.valid_batches()))
  model = pipe.final_state.model.eval()
  with torch.no_grad():
    logits = model(batch.context, batch.examples, batch.mask)
  torch.save({'history': history, 'logits': _np(logits), 'batch': batch,
              'mesh': (pipe.mesh.data, pipe.mesh.model)},
             os.path.join(tmp, f'cli_{rank}.pt'))
  dist.destroy_process_group()


def spawn_cli(tmp, world, argv):
  """Runs the CLI on ``world`` ranks; returns each rank's results."""
  import torch.multiprocessing as mp
  os.makedirs(tmp, exist_ok=True)
  mp.spawn(run_cli, args=(world, tmp, tuple(argv)), nprocs=world, join=True)
  return [torch.load(os.path.join(tmp, f'cli_{r}.pt'), weights_only=False)
          for r in range(world)]


def start(runs):
  """Starts every world of ``runs`` (``{world: (tmp, inputs)}``, inputs
  ``{case: ((data, model), inputs)}``) at once, each a process a rank with
  its own rendezvous, and returns at once: the caller computes its
  references while the ranks run, then calls ``join``."""
  import torch.multiprocessing as mp
  contexts = {}
  for world, (tmp, inputs) in runs.items():
    os.makedirs(tmp, exist_ok=True)
    torch.save(inputs, os.path.join(tmp, 'in.pt'))
    contexts[world] = mp.start_processes(run, args=(world, tmp), nprocs=world,
                                         join=False, start_method='spawn')
  return runs, contexts


def join(started):
  """Waits for the ranks of ``start`` and returns ``{world: [each rank's
  results]}``."""
  runs, contexts = started
  for context in contexts.values():
    while not context.join():
      pass
  return {world: [torch.load(os.path.join(tmp, f'out_{r}.pt'),
                             weights_only=False) for r in range(world)]
          for world, (tmp, _) in runs.items()}


def spawn(runs):
  """``start`` and ``join``."""
  return join(start(runs))
