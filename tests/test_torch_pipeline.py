"""The port's pipeline == the JAX package's, on the CPU.

``SimplePipeline.train_and_validate`` over LIBSVM files written from a
numpy seed (DNN (16, 8) without batch norm, B4 x L8 x F6, two epochs of
three steps, ``steps_per_execution`` 2, softmax loss, Adam 0.05) runs in
both packages from the JAX pipeline's own initial weights, carried over
with ``convert.from_flax``. Per epoch, ``loss``, ``val_loss`` and the NDCG
suite must agree within rtol 1e-4: float32 sums in another order, through
six Adam steps at a rate of 0.05. The parameters after the run are held
within 1e-3 of the largest value, except the output bias: under the
softmax loss its true gradient is 0, so its computed gradient is rounding
noise that Adam at eps 1e-8 turns into whole-rate moves, in directions that
differ between any two implementations. Its moves leave the loss and the
ranking unchanged, since the loss and NDCG do not see a shift of every
score of a list.

On the port alone: ``steps_per_execution`` 2 equals 1 bitwise (and a
profiled epoch writes its trace); a run interrupted after one epoch and
resumed with ``resume_dataset`` equals the straight run bitwise; best
tracking keeps the latest checkpoints; the plateau hook lowers the rate;
early stopping stops; the schedules, clipping and optimizers equal optax's
step by step.

Over ELWC files written by the port's encoder, ``SimpleDatasetBuilder``
(the native loader) feeds ``train_and_validate`` to the JAX pipeline's
per-epoch metrics within the same rtol 1e-4; a resumed run skips its
batches through ``skip_batches`` and ends bitwise where the straight run
ends, for both engines; bucketed list sizes run one step a dispatch on the
CPU and raise under K > 1 on CUDA.
"""

import itertools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ranking_tpu import models as jax_models
from ranking_tpu import train as jax_train
from ranking_tpu.data import parsers as jax_parsers
from ranking_tpu.pipeline import hparams as jax_hparams
from ranking_tpu.pipeline import pipeline as jax_pipeline
from ranking_tpu_torch import convert
from ranking_tpu_torch.data import libsvm
from ranking_tpu_torch.data import parsers
from ranking_tpu_torch.data import proto as torch_proto
from ranking_tpu_torch.data import tfrecord
from ranking_tpu_torch.models import scorers
from ranking_tpu_torch.pipeline import hparams as hparams_lib
from ranking_tpu_torch.pipeline import pipeline
from ranking_tpu_torch.train import checkpoint
from ranking_tpu_torch.train import state as state_lib

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

B, L, F, HIDDEN = 4, 8, 6, (16, 8)
RUN = dict(num_epochs=2, steps_per_epoch=3, validation_steps=100,
           learning_rate=0.05, loss='softmax_loss', steps_per_execution=2)
METRICS = ('loss', 'val_loss', 'ndcg@1', 'ndcg@5', 'ndcg@10', 'ndcg')


@pytest.fixture(scope='module')
def files(tmp_path_factory):
  root = tmp_path_factory.mktemp('libsvm')
  train, vali = str(root / 'train.txt'), str(root / 'vali.txt')
  libsvm.write_random_lists(train, 24, F, 3, 10, seed=1)
  libsvm.write_random_lists(vali, 10, F, 3, 10, seed=2)
  return train, vali


@pytest.fixture(scope='module')
def jax_run(files, tmp_path_factory):
  """The JAX pipeline's run, its per-epoch log, final parameters, and its
  initial weights as the port's state_dict."""
  model_dir = str(tmp_path_factory.mktemp('jax') / 'model')
  builder = jax_pipeline.LibSVMDatasetBuilder(*files, L, F, B)
  model = jax_models.RankingModel(
      scorer=jax_models.DNNScorer(hidden_layer_dims=HIDDEN, dropout=0.0,
                                  use_batch_norm=False),
      transform_name='log1p')
  hp = jax_hparams.PipelineHparams(model_dir=model_dir, mesh_data=1, **RUN)
  pipe = jax_pipeline.SimplePipeline(model, builder, hp)
  pipe.train_and_validate()
  # The initial state exactly as _build makes it (init reads only shapes).
  first = next(iter(builder.train_batches()))
  initial = jax_train.create_train_state(
      model, optax.adam(hp.learning_rate), jax.random.PRNGKey(hp.seed),
      first.context, first.examples, first.mask)
  return (_log(model_dir),
          jax.tree.map(np.asarray, {'params': pipe.final_state.params}),
          convert.from_flax(jax.tree.map(np.asarray,
                                         {'params': initial.params})))


def _log(model_dir):
  with open(os.path.join(model_dir, 'metrics.jsonl')) as f:
    return [json.loads(line) for line in f]


def _model(state_dict):
  model = scorers.RankingModel(
      scorers.DNNScorer(HIDDEN, in_features=F, dropout=0.0,
                        use_batch_norm=False), transform_name='log1p')
  model.load_state_dict(state_dict)
  return model


def _run(files, state_dict, model_dir, **kw):
  hp = hparams_lib.PipelineHparams(model_dir=str(model_dir),
                                   **{**RUN, **kw})
  builder = pipeline.LibSVMDatasetBuilder(*files, L, F, B)
  pipe = pipeline.SimplePipeline(_model(state_dict), builder, hp,
                                 device='cpu')
  history = pipe.train_and_validate()
  return pipe, history


def _params(pipe):
  return {k: v.detach().clone()
          for k, v in pipe.final_state.model.state_dict().items()}


def test_pipeline_matches_the_jax_pipeline(files, jax_run, tmp_path):
  want_log, want_params, initial = jax_run
  pipe, history = _run(files, initial, tmp_path / 'model')
  got_log = _log(tmp_path / 'model')
  assert [r['step'] for r in got_log] == [r['step'] for r in want_log] == [
      3, 6]
  for got, want in zip(got_log, want_log):
    for name in METRICS:
      np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                 err_msg=f'step {got["step"]} {name}')
  assert history == {k: v for k, v in got_log[-1].items() if k != 'step'}
  got = convert.to_flax(_params(pipe))['params']
  output_bias = f'Dense_{len(HIDDEN)}'
  for layer, leaves in want_params['params']['scorer']['Tower_0'].items():
    for name, want in leaves.items():
      if (layer, name) == (output_bias, 'bias'):
        continue
      have = got['scorer']['Tower_0'][layer][name]
      np.testing.assert_allclose(have, want, rtol=0,
                                 atol=1e-3 * np.abs(want).max(),
                                 err_msg=f'{layer}/{name}')
  assert pipe.final_state.step == 6
  for name in ('checkpoints/ckpt_3.pt', 'checkpoints/ckpt_6.pt',
               'export/latest/params.pt'):
    assert (tmp_path / 'model' / name).exists(), name
  assert len(os.listdir(tmp_path / 'model' / 'tensorboard')) == 1


def test_steps_per_execution_equals_one_step_a_dispatch(files, jax_run,
                                                        tmp_path):
  _, _, initial = jax_run
  two, history_two = _run(files, initial, tmp_path / 'two')
  one, history_one = _run(files, initial, tmp_path / 'one',
                          steps_per_execution=1,
                          profile_dir=str(tmp_path / 'trace'),
                          profile_epoch=2)
  assert (tmp_path / 'trace' / 'trace_epoch2.json').exists()
  assert history_one.pop('examples_per_sec') > 0
  history_two.pop('examples_per_sec')
  assert history_one == history_two
  for k, v in _params(one).items():
    assert torch.equal(v, _params(two)[k]), k


def test_resume_dataset_is_bitwise_the_straight_run(files, jax_run,
                                                    tmp_path):
  _, _, initial = jax_run
  straight, _ = _run(files, initial, tmp_path / 'straight',
                     resume_dataset=True)
  _run(files, initial, tmp_path / 'resumed', num_epochs=1,
       resume_dataset=True)
  resumed, _ = _run(files, initial, tmp_path / 'resumed',
                    resume_dataset=True)
  assert resumed.final_state.step == 6
  for k, v in _params(straight).items():
    assert torch.equal(v, _params(resumed)[k]), k
  a, b = straight.final_state.optimizer, resumed.final_state.optimizer
  assert torch.equal(a.count, b.count) and torch.equal(a.lr, b.lr)
  for p, q in zip(a.param_groups[0]['params'], b.param_groups[0]['params']):
    for key in ('step', 'exp_avg', 'exp_avg_sq'):
      assert torch.equal(a.state[p][key], b.state[q][key]), key


def test_best_checkpoint_tracked_and_latest_kept(files, jax_run, tmp_path):
  _, _, initial = jax_run
  best = dict(export_best_model=True, best_exporter_metric='ndcg@5',
              best_exporter_metric_higher_better=True)
  pipe, _ = _run(files, initial, tmp_path, num_epochs=3, **best)
  assert pipe.ckpt.latest_step() == 9
  best_step = pipe.ckpt.best_step()
  assert 1 <= best_step <= 9
  logged = {r['step']: r['ndcg@5'] for r in _log(tmp_path)}
  assert logged[best_step] == max(logged.values())
  assert len(os.listdir(tmp_path / 'checkpoints' / 'best')) == 2
  # A fresh pipeline resumes from the latest step, not the best.
  pipe, _ = _run(files, initial, tmp_path, num_epochs=4, **best)
  assert pipe.final_state.step == 12
  best_params = checkpoint.load_params(str(tmp_path / 'export' / 'best'))
  kept = torch.load(tmp_path / 'checkpoints' / 'best' /
                    f'ckpt_{pipe.ckpt.best_step()}.pt', weights_only=True)
  for k, v in best_params.items():
    assert torch.equal(v, kept['model'][k]), k
  assert (tmp_path / 'export' / 'latest' / 'params.pt').exists()
  # A checkpoint of another structure is refused with the explanation.
  other = pipeline.SimplePipeline(
      scorers.RankingModel(scorers.DNNScorer((5,), in_features=F,
                                             use_batch_norm=False)),
      pipeline.LibSVMDatasetBuilder(*files, L, F, B),
      hparams_lib.PipelineHparams(model_dir=str(tmp_path), **RUN),
      device='cpu')
  with pytest.raises(ValueError, match='does not match the current'):
    other.train_and_validate()


def test_reduce_lr_on_plateau(files, jax_run, tmp_path):
  _, _, initial = jax_run
  pipe, _ = _run(files, initial, tmp_path, num_epochs=12, steps_per_epoch=1,
                 validation_steps=1, learning_rate=1e-9,
                 automatic_reduce_lr=True)
  assert pipe.final_state.optimizer.lr.item() < 1e-9 * 0.2


def test_early_stopping(files, jax_run, tmp_path):
  """A rate of 0 leaves val_loss where it was: the first epoch improves on
  inf, the second does not, and a patience of 1 stops the run there."""
  _, _, initial = jax_run
  pipe, _ = _run(files, initial, tmp_path, num_epochs=5, steps_per_epoch=1,
                 learning_rate=0.0, early_stopping_patience=1,
                 early_stopping_min_delta=0.01)
  assert pipe.final_state.step == 2
  assert [r['step'] for r in _log(tmp_path)] == [1, 2]


_SCHEDULES = [
    dict(lr_schedule='linear_decay', warmup_steps=10),
    dict(lr_schedule='cosine_decay'),
    dict(lr_schedule='cosine_decay', warmup_steps=7, end_learning_rate=1e-3),
    dict(lr_schedule='constant', warmup_steps=5),
    dict(lr_schedule='linear_decay', end_learning_rate=0.01),
]


@pytest.mark.parametrize('kw', _SCHEDULES,
                         ids=['linear_warmup', 'cosine', 'cosine_warmup',
                              'constant_warmup', 'linear'])
def test_schedules_equal_optax(kw):
  """Every count 0..119, against the JAX package's optax schedule. torch's
  cos may round one ulp of 1 away from XLA's, which stays an absolute
  error of lr * 2^-23 after ``0.5 * (1 + cos)`` (relative to the rate it is
  large where the cosine nears -1); the rest is two float32 ulps."""
  hp = dict(model_dir='unused', num_epochs=10, steps_per_epoch=10,
            validation_steps=1, learning_rate=0.05, loss='softmax_loss', **kw)
  want_fn = jax_hparams.lr_schedule_from_hparams(
      jax_hparams.PipelineHparams(**hp))
  got_fn = hparams_lib.lr_schedule_from_hparams(
      hparams_lib.PipelineHparams(**hp))
  counts = np.arange(120, dtype=np.int32)
  want = np.array([np.float32(want_fn(jnp.int32(c))) for c in counts])
  got = np.array([got_fn(torch.tensor(c)).item() for c in counts],
                 np.float32)
  np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0.05 * 2 ** -23)


@pytest.mark.parametrize('name', ['sgd', 'adam', 'adamw', 'adagrad'])
def test_optimizers_with_schedule_and_clipping_equal_optax(name):
  """Four steps of ``optimizer_from_hparams`` (warmup, linear decay, clip
  norm 1) against the JAX package's on the same gradients; the third
  gradient is below the clip norm. sgd's arithmetic is optax's, so it is
  held bitwise; the others within 1e-6 of the largest parameter (torch's
  Adam folds the bias corrections into the step in another order)."""
  hp = dict(model_dir='unused', num_epochs=2, steps_per_epoch=4,
            validation_steps=1, learning_rate=0.1, loss='softmax_loss',
            optimizer=name, lr_schedule='linear_decay', warmup_steps=2,
            gradient_clip_norm=1.0)
  tx = jax_hparams.optimizer_from_hparams(jax_hparams.PipelineHparams(**hp))
  rng = np.random.RandomState(0)
  init = {'a': rng.randn(3, 4).astype(np.float32),
          'b': rng.randn(5).astype(np.float32)}
  params = {k: jnp.asarray(v) for k, v in init.items()}
  opt_state = tx.init(params)
  tparams = [torch.nn.Parameter(torch.from_numpy(init[k].copy()))
             for k in ('a', 'b')]
  opt = hparams_lib.optimizer_from_hparams(
      hparams_lib.PipelineHparams(**hp))(tparams)
  for i in range(4):
    scale = 0.01 if i == 2 else 3.0
    grads = {k: (rng.randn(*v.shape) * scale).astype(np.float32)
             for k, v in init.items()}
    updates, opt_state = tx.update({k: jnp.asarray(v)
                                    for k, v in grads.items()},
                                   opt_state, params)
    params = optax.apply_updates(params, updates)
    for p, k in zip(tparams, ('a', 'b')):
      p.grad = torch.from_numpy(grads[k])
    opt.step()
    for p, k in zip(tparams, ('a', 'b')):
      want = np.asarray(params[k])
      atol = 0.0 if name == 'sgd' else 1e-6 * np.abs(want).max()
      np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                 atol=atol, err_msg=f'step {i} {k}')
  assert opt.count.item() == 4


def test_clip_by_global_norm_equals_optax():
  rng = np.random.RandomState(1)
  for scale in (0.01, 5.0):
    grads = [(rng.randn(7, 3) * scale).astype(np.float32),
             (rng.randn(4) * scale).astype(np.float32)]
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    got = [torch.from_numpy(g.copy()) for g in grads]
    state_lib.clip_by_global_norm_(got, 1.0)
    for g, w in zip(got, want):
      np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_hparams_guards():
  base = dict(model_dir='unused', num_epochs=1, steps_per_epoch=1,
              validation_steps=1, learning_rate=0.1, loss='softmax_loss')
  with pytest.raises(ValueError, match='Unknown lr_schedule'):
    hparams_lib.lr_schedule_from_hparams(hparams_lib.PipelineHparams(
        lr_schedule='exponential', **base))
  with pytest.raises(ValueError, match='mutually'):
    hparams_lib.lr_schedule_from_hparams(hparams_lib.PipelineHparams(
        lr_schedule='linear_decay', automatic_reduce_lr=True, **base))
  with pytest.raises(ValueError, match='constant learning rate only'):
    hparams_lib.sparse_optimizer_from_hparams(hparams_lib.PipelineHparams(
        optimizer='lazy_adam', lr_schedule='linear_decay', **base))
  with pytest.raises(ValueError, match='Unknown optimizer'):
    hparams_lib.optimizer_from_hparams(hparams_lib.PipelineHparams(
        optimizer='lamb', **base))
  # A mesh larger than the ranks of the process group (none here, one
  # rank) is refused where the pipeline lays it out.
  from ranking_tpu_torch import parallel
  hparams_lib.PipelineHparams(mesh_data=2, **base)
  with pytest.raises(ValueError, match='exceeds 1 ranks'):
    parallel.make_mesh(data=2)
  with pytest.raises(ValueError, match='not divisible by model=2'):
    parallel.make_mesh(model=2)
  assert hparams_lib.sparse_optimizer_from_hparams(
      hparams_lib.PipelineHparams(optimizer='lazy_adagrad', **base)
  ).learning_rate == 0.1


# --- serialized ELWC through SimpleDatasetBuilder ----------------------------


def _elwc_specs(pkg):
  return {}, {'float_features': pkg.FixedLenFeature((F,), 'float32', 0.0),
              'relevance': pkg.FixedLenFeature((), 'int64', 0)}


@pytest.fixture(scope='module')
def elwc_files(tmp_path_factory):
  """Two train files of 12 lists and a validation file of 10, ELWC from a
  numpy seed (3 to 10 documents a list, labels from a noisy linear
  score)."""
  root = tmp_path_factory.mktemp('elwc')
  rng = np.random.RandomState(4)
  w = rng.randn(F)
  for name, lists in (('train-0', 12), ('train-1', 12), ('vali', 10)):
    records = []
    for _ in range(lists):
      x = rng.randn(rng.randint(3, 11), F).astype(np.float32)
      rel = np.clip(np.round(x @ w + rng.randn(len(x)) + 1), 0, 4)
      records.append(torch_proto.make_elwc({}, [
          {'float_features': xi, 'relevance': [int(r)]}
          for xi, r in zip(x, rel)]))
    tfrecord.write_records(str(root / f'{name}.tfrecord'), records)
  return str(root / 'train-*.tfrecord'), str(root / 'vali.tfrecord')


def _elwc_builder(pkg, pipeline_module, files, seed=3, **kw):
  context, example = _elwc_specs(pkg.parsers)
  hp = pkg.hparams.DatasetHparams(
      train_input_pattern=files[0], valid_input_pattern=files[1],
      train_batch_size=B, valid_batch_size=B,
      **{'list_size': L, 'shuffle_buffer_size': 8, **kw})
  return pipeline_module.SimpleDatasetBuilder(context, example, hp,
                                              seed=seed)


_JAX = types.SimpleNamespace(parsers=jax_parsers, hparams=jax_hparams)
_PORT = types.SimpleNamespace(parsers=parsers, hparams=hparams_lib)


@pytest.fixture(scope='module')
def jax_elwc_run(elwc_files, tmp_path_factory):
  model_dir = str(tmp_path_factory.mktemp('jax_elwc') / 'model')
  builder = _elwc_builder(_JAX, jax_pipeline, elwc_files)
  model = jax_models.RankingModel(
      scorer=jax_models.DNNScorer(hidden_layer_dims=HIDDEN, dropout=0.0,
                                  use_batch_norm=False),
      transform_name='log1p')
  hp = jax_hparams.PipelineHparams(model_dir=model_dir, mesh_data=1, **RUN)
  jax_pipeline.SimplePipeline(model, builder, hp).train_and_validate()
  first = next(iter(builder.train_batches()))
  initial = jax_train.create_train_state(
      model, optax.adam(hp.learning_rate), jax.random.PRNGKey(hp.seed),
      first.context, first.examples, first.mask)
  return _log(model_dir), convert.from_flax(
      jax.tree.map(np.asarray, {'params': initial.params}))


def _elwc_run(files, state_dict, model_dir, engine='auto', cache=None, **kw):
  builder = _elwc_builder(_PORT, pipeline, files, dataset_engine=engine,
                          dataset_cache=cache)
  hp = hparams_lib.PipelineHparams(model_dir=str(model_dir),
                                   **{**RUN, **kw})
  pipe = pipeline.SimplePipeline(_model(state_dict), builder, hp,
                                 device='cpu')
  pipe.train_and_validate()
  return pipe


def test_elwc_pipeline_matches_the_jax_pipeline(elwc_files, jax_elwc_run,
                                                tmp_path):
  """The same ELWC files through both packages' SimpleDatasetBuilder (the
  native loaders, whose batch orders are equal) and train_and_validate:
  every epoch's metrics within the LIBSVM test's rtol 1e-4."""
  want_log, initial = jax_elwc_run
  pipe = _elwc_run(elwc_files, initial, tmp_path / 'model')
  assert pipe.dataset_builder.engine == {'train': 'native_loader',
                                         'valid': 'native_loader'}
  assert [v['cache'] for v in pipe.dataset_builder.loader.values()] == [
      'off', 'off']
  got_log = _log(tmp_path / 'model')
  assert [r['step'] for r in got_log] == [r['step'] for r in want_log] == [
      3, 6]
  for got, want in zip(got_log, want_log):
    for name in METRICS:
      np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                 err_msg=f'step {got["step"]} {name}')
  assert (tmp_path / 'model' / 'export' / 'latest' / 'params.pt').exists()


@pytest.mark.parametrize('engine', ['native_loader', 'native_loader_cached',
                                    'python'])
def test_elwc_resume_skips_batches_bitwise(elwc_files, jax_elwc_run,
                                          tmp_path, engine, monkeypatch):
  """A run stopped after one epoch and resumed with ``resume_dataset``
  fast-forwards through the builder's ``skip_batches`` (nothing pulled and
  dropped) and ends bitwise where the straight run ends; with the epoch
  cache, the first run builds it and the resumed run reads it."""
  _, initial = jax_elwc_run
  cache = None
  if engine == 'native_loader_cached':
    engine, cache = 'native_loader', str(tmp_path / 'cache')
  straight = _elwc_run(elwc_files, initial, tmp_path / 'straight', engine,
                       resume_dataset=True)
  first = _elwc_run(elwc_files, initial, tmp_path / 'resumed', engine,
                    cache=cache, num_epochs=1, resume_dataset=True)
  skips = []
  train_batches = pipeline.SimpleDatasetBuilder.train_batches

  def recording(self, skip_batches=0):
    skips.append(skip_batches)
    return train_batches(self, skip_batches)

  monkeypatch.setattr(pipeline.SimpleDatasetBuilder, 'train_batches',
                      recording)
  resumed = _elwc_run(elwc_files, initial, tmp_path / 'resumed', engine,
                      cache=cache, resume_dataset=True)
  assert skips == [0, 3] and resumed.final_state.step == 6
  if cache:
    assert first.dataset_builder.loader['train']['cache'] == 'build'
    assert resumed.dataset_builder.loader['train']['cache'] == 'read'
  for k, v in _params(straight).items():
    assert torch.equal(v, _params(resumed)[k]), k


def test_bucketed_list_sizes(elwc_files, jax_elwc_run, tmp_path):
  """list_size=None: the Python stream pads each batch to its bucket; on
  the CPU the batches run one a dispatch; on CUDA K steps a dispatch
  raise, since a graph replays one batch shape."""
  _, initial = jax_elwc_run
  builder = _elwc_builder(_PORT, pipeline, elwc_files, list_size=None)
  assert builder.engine == {'train': 'python', 'valid': 'python'}
  shapes = {tuple(b.mask.shape) for b in itertools.islice(
      builder.train_batches(), 6)}
  assert len(shapes) > 1 and all(s[0] == B for s in shapes)
  hp = hparams_lib.PipelineHparams(model_dir=str(tmp_path), **RUN)
  pipe = pipeline.SimplePipeline(_model(initial), builder, hp, device='cpu')
  assert pipe._steps_per_dispatch() == 1
  history = pipe.train_and_validate()
  assert np.isfinite(history['loss']) and pipe.final_state.step == 6
  pipe.device = torch.device('cuda')
  with pytest.raises(ValueError, match='steps_per_execution=2 with '
                                       'list_size=None'):
    pipe._steps_per_dispatch()


def test_dataset_builder_guards(elwc_files):
  with pytest.raises(ValueError, match='dataset_engine'):
    _elwc_builder(_PORT, pipeline, elwc_files, dataset_engine='tf.data')
  with pytest.raises(ValueError, match='dataset_cache'):
    _elwc_builder(_PORT, pipeline, elwc_files, dataset_engine='python',
                  dataset_cache='unused')
  # The loader asked for by name is taken, and raises for specs it does
  # not serve; nothing falls back to the Python stream.
  builder = pipeline.SimpleDatasetBuilder(
      {}, {'float_features': parsers.VarLenFeature('float32', max_len=F),
           'relevance': parsers.FixedLenFeature((), 'int64', 0)},
      hparams_lib.DatasetHparams(
          train_input_pattern=elwc_files[0],
          valid_input_pattern=elwc_files[1], train_batch_size=B,
          valid_batch_size=B, list_size=L, dataset_engine='native_loader'))
  with pytest.raises(ValueError, match='varlen'):
    builder.train_batches()
