"""The port's multi-task training == the JAX package's, on the CPU.

``MultiTaskScorer`` in both forms (the DNN body built inside, and a given
``DNNScorer`` or ``EmbeddingDNNScorer`` body) is carried over from flax with
``convert.from_flax`` and scores the same batch as the JAX model (atol 1e-5:
float32 matmuls summed in another order); ``to_flax`` gives the flax tree
back bit for bit. ``make_eval_step`` routes ``task/metric`` names to that
task's logits and labels, names without ``/`` to the first task, raises on
an unknown task, and streams the weighted multi-task val loss, as
``ranking_tpu.train.make_eval_step`` does (rtol 1e-5). Over ELWC files with a
relevance and a click label, ``MultiLabelDatasetBuilder`` feeds
``MultiTaskPipeline.train_and_validate`` (two epochs of three steps, softmax
on relevance and sigmoid cross-entropy on clicks, weights 1 and 0.3, dropout
0), whose per-epoch metrics must equal the JAX pipeline's within the rtol
1e-4 of ``tests/test_torch_pipeline.py``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ranking_tpu import models as jax_models
from ranking_tpu import ops as jax_ops
from ranking_tpu import train as jax_train
from ranking_tpu.data import parsers as jax_parsers
from ranking_tpu.data.batch import RankingBatch as JaxBatch
from ranking_tpu.pipeline import hparams as jax_hparams
from ranking_tpu.pipeline import pipeline as jax_pipeline
from ranking_tpu_torch import convert
from ranking_tpu_torch.data import parsers
from ranking_tpu_torch.data import proto as torch_proto
from ranking_tpu_torch.data import tfrecord
from ranking_tpu_torch.data.batch import RankingBatch
from ranking_tpu_torch.models import scorers
from ranking_tpu_torch.ops import loss_registry, metric_registry
from ranking_tpu_torch.pipeline import hparams as hparams_lib
from ranking_tpu_torch.pipeline import pipeline
from ranking_tpu_torch.train import steps

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

B, L, F, HIDDEN = 4, 8, 6, (16, 8)
TASKS = ('relevance', 'click')
VOCAB, DIM, T = 30, 3, 4


def _batch(seed=0):
  rng = np.random.RandomState(seed)
  examples = (rng.randn(B, L, F) * 2).astype(np.float32)
  mask = rng.rand(B, L) > 0.25
  mask[:, 0] = True
  mask[1, 3:] = False
  relevance = np.where(mask, rng.randint(0, 5, (B, L)), -1).astype(np.float32)
  relevance[2] = np.where(mask[2], 0.0, -1.0)    # no relevant document
  click = np.where(mask, (relevance > 0) & (rng.rand(B, L) < 0.7),
                   -1).astype(np.float32)
  tokens = rng.randint(-1, VOCAB, (B, L, T)).astype(np.int32)
  return examples, tokens, mask, {'relevance': relevance, 'click': click}


def _randomize(tree, rng):
  def leaf(path, x):
    x = np.asarray(x)
    if 'var' in jax.tree_util.keystr(path):
      return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
    return (rng.randn(*x.shape) * 0.5).astype(x.dtype)
  return jax.tree_util.tree_map_with_path(leaf, tree)


def _models(form):
  """(JAX model, port model, example features of each) for a form."""
  if form == 'built':
    jscorer = jax_models.MultiTaskScorer(task_names=TASKS,
                                         hidden_layer_dims=HIDDEN,
                                         dropout=0.0)
    tscorer = scorers.MultiTaskScorer(TASKS, HIDDEN, in_features=F,
                                      dropout=0.0)
  elif form == 'dnn_body':
    jscorer = jax_models.MultiTaskScorer(
        task_names=TASKS, body=jax_models.DNNScorer(
            hidden_layer_dims=HIDDEN, output_units=2, dropout=0.0))
    tscorer = scorers.MultiTaskScorer(TASKS, body=scorers.DNNScorer(
        HIDDEN, in_features=F, output_units=2, dropout=0.0))
  else:
    jscorer = jax_models.MultiTaskScorer(
        task_names=TASKS, body=jax_models.EmbeddingDNNScorer(
            hidden_layer_dims=HIDDEN, output_units=2,
            vocab_sizes={'tokens': VOCAB}, embedding_dim=DIM, dropout=0.0))
    tscorer = scorers.MultiTaskScorer(TASKS, body=scorers.EmbeddingDNNScorer(
        HIDDEN, {'tokens': VOCAB}, embedding_dim=DIM, dense_width=F,
        output_units=2, dropout=0.0))
  return (jax_models.RankingModel(scorer=jscorer, transform_name='log1p'),
          scorers.RankingModel(tscorer, transform_name='log1p'))


def _features(form, examples, tokens):
  feats = {'x': examples}
  if form == 'embedding_body':
    feats['tokens'] = tokens
  return feats


@pytest.mark.parametrize('form', ['built', 'dnn_body', 'embedding_body'])
def test_multitask_scorer_carried_over_from_flax(form):
  examples, tokens, mask, _ = _batch()
  feats = _features(form, examples, tokens)
  jmodel, tmodel = _models(form)
  variables = jax.jit(jmodel.init, static_argnames='training')(
      jax.random.PRNGKey(0), {}, feats, jnp.asarray(mask), training=False)
  variables = _randomize(jax.tree.map(np.asarray, dict(variables)),
                         np.random.RandomState(1))
  paths = {'built': ('DNNScorer_0', 'Tower_0'), 'dnn_body': ('body',
                                                             'Tower_0'),
           'embedding_body': ('body', 'dnn', 'Tower_0')}[form]
  assert convert._at(variables['params']['scorer'], paths) is not None
  tmodel.load_state_dict(convert.from_flax(variables))
  want = jax.jit(jmodel.apply, static_argnames='training')(
      variables, {}, feats, jnp.asarray(mask), training=False)
  got = tmodel({}, {k: torch.from_numpy(v) for k, v in feats.items()},
               torch.from_numpy(mask))
  assert sorted(got) == sorted(want) == sorted(TASKS)
  for task in TASKS:
    assert got[task].shape == (B, L)
    np.testing.assert_allclose(got[task].detach().numpy(),
                               np.asarray(want[task]), atol=1e-5, rtol=0)
  back = convert.to_flax(tmodel.state_dict())
  jax.tree.map(np.testing.assert_array_equal, back, variables)


def test_multitask_scorer_guards():
  with pytest.raises(ValueError, match='output_units=1 != 2 tasks'):
    scorers.MultiTaskScorer(TASKS, body=scorers.DNNScorer((4,), in_features=3))
  with pytest.raises(ValueError, match='in_features'):
    scorers.MultiTaskScorer(TASKS, (4,))
  with pytest.raises(ValueError, match='exactly one of'):
    convert.from_flax({'params': {'scorer': {'body': {}}}})
  model = scorers.RankingModel(scorers.MultiTaskScorer(TASKS, (4,),
                                                       in_features=3))
  with pytest.raises(ValueError, match='more than one tower layout'):
    convert.to_flax({**model.state_dict(),
                     'scorer.tower.dense.0.bias': torch.zeros(4)})


METRICS = {
    'relevance/ndcg@5': ('ndcg', 5), 'click/ndcg': ('ndcg', None),
    'relevance/mrr': ('mrr', None), 'ndcg@3': ('ndcg', 3),
}
LOSSES = {'relevance': 'softmax_loss', 'click': 'sigmoid_cross_entropy_loss'}
WEIGHTS = {'relevance': 1.0, 'click': 0.3}


def _eval_pair():
  examples, tokens, mask, labels = _batch(2)
  jmodel, tmodel = _models('built')
  state = jax_train.create_train_state(
      jmodel, optax.adam(0.1), jax.random.PRNGKey(0), {}, {'x': examples},
      jnp.asarray(mask))
  variables = _randomize(
      jax.tree.map(np.asarray, {'params': state.params,
                                'batch_stats': state.batch_stats}),
      np.random.RandomState(3))
  state = state.replace(params=variables['params'],
                        batch_stats=variables['batch_stats'])
  tmodel.load_state_dict(convert.from_flax(variables))
  tmodel.eval()
  jbatch = JaxBatch(context={}, examples={'x': jnp.asarray(examples)},
                    labels={k: jnp.asarray(v) for k, v in labels.items()},
                    mask=jnp.asarray(mask))
  tbatch = RankingBatch(
      context={}, examples={'x': torch.from_numpy(examples)},
      labels={k: torch.from_numpy(v) for k, v in labels.items()},
      mask=torch.from_numpy(mask))
  return state, tmodel, jbatch, tbatch


def test_multitask_eval_step_routes_and_weighs_as_jax():
  state, tmodel, jbatch, tbatch = _eval_pair()
  jfns = {n: jax_ops.make_ranking_metric_fn(k, topn=t)
          for n, (k, t) in METRICS.items()}
  tfns = {n: metric_registry.make_ranking_metric_fn(k, topn=t)
          for n, (k, t) in METRICS.items()}
  jstep = jax_train.make_eval_step(
      jfns, loss_fn={t: jax_ops.make_loss_fn(k) for t, k in LOSSES.items()},
      multi_task_weights=WEIGHTS)
  tstep = steps.make_eval_step(
      tfns, loss_fn={t: loss_registry.make_loss_fn(k)
                     for t, k in LOSSES.items()},
      multi_task_weights=WEIGHTS, device='cpu')
  jstates, jlogits = jax.jit(jstep)(
      state, jbatch, jax_train.init_metric_states(jfns, with_loss=True))
  tstates, tlogits = tstep(
      tmodel, tbatch,
      steps.init_metric_states(tfns, with_loss=True, device='cpu'))
  assert sorted(tlogits) == sorted(TASKS)
  for name in list(METRICS) + ['loss']:
    np.testing.assert_allclose(tstates[name].result().item(),
                               float(jstates[name].result()), rtol=1e-5,
                               atol=1e-6, err_msg=name)
  # The routing: a name without '/' scores the first task in sorted order.
  ndcg3 = metric_registry.make_ranking_metric_fn('ndcg', topn=3)(
      tbatch.labels['click'], tlogits['click'])
  assert tstates['ndcg@3'].result().item() == pytest.approx(
      ((ndcg3[0] * ndcg3[1]).sum() / ndcg3[1].sum()).item(), rel=1e-6)
  # The weighted val loss: 1.0 softmax + 0.3 sigmoid cross-entropy.
  want_loss = sum(
      WEIGHTS[t] * loss_registry.make_loss_fn(k)(tbatch.labels[t],
                                                 tlogits[t])
      for t, k in LOSSES.items())
  assert tstates['loss'].result().item() == pytest.approx(want_loss.item(),
                                                          rel=1e-6)


def test_multitask_eval_step_refuses_unknown_tasks():
  _, tmodel, _, tbatch = _eval_pair()
  fns = {'clicks/ndcg': metric_registry.make_ranking_metric_fn('ndcg')}
  step = steps.make_eval_step(fns, device='cpu')
  with pytest.raises(ValueError, match="unknown task 'clicks'"):
    step(tmodel, tbatch, steps.init_metric_states(fns, device='cpu'))
  with pytest.raises(ValueError, match='names unknown tasks'):
    steps.make_eval_step(
        fns, loss_fn={t: loss_registry.make_loss_fn(k)
                      for t, k in LOSSES.items()},
        multi_task_weights={'clicks': 1.0}, device='cpu')


# --- MultiTaskPipeline over ELWC files with two labels -----------------------

RUN = dict(num_epochs=2, steps_per_epoch=3, validation_steps=100,
           learning_rate=0.05, loss=LOSSES, loss_weights=WEIGHTS,
           steps_per_execution=2)


def _specs(pkg):
  return {}, {'float_features': pkg.FixedLenFeature((F,), 'float32', 0.0),
              'relevance': pkg.FixedLenFeature((), 'int64', 0),
              'click': pkg.FixedLenFeature((), 'int64', 0)}


@pytest.fixture(scope='module')
def files(tmp_path_factory):
  """Two train files of 12 lists and a validation file of 10: 3 to 10
  documents a list, labels from a noisy linear score, and a click on a
  relevant document with probability 0.7."""
  root = tmp_path_factory.mktemp('multitask')
  rng = np.random.RandomState(5)
  w = rng.randn(F)
  for name, lists in (('train-0', 12), ('train-1', 12), ('vali', 10)):
    records = []
    for _ in range(lists):
      x = rng.randn(rng.randint(3, 11), F).astype(np.float32)
      rel = np.clip(np.round(x @ w + rng.randn(len(x)) + 1), 0, 4)
      click = (rel > 0) & (rng.rand(len(x)) < 0.7)
      records.append(torch_proto.make_elwc({}, [
          {'float_features': xi, 'relevance': [int(r)], 'click': [int(c)]}
          for xi, r, c in zip(x, rel, click)]))
    tfrecord.write_records(str(root / f'{name}.tfrecord'), records)
  return str(root / 'train-*.tfrecord'), str(root / 'vali.tfrecord')


def _builder(pipeline_module, hparams_module, spec_module, files):
  context, example = _specs(spec_module)
  hp = hparams_module.DatasetHparams(
      train_input_pattern=files[0], valid_input_pattern=files[1],
      train_batch_size=B, valid_batch_size=B, list_size=L,
      shuffle_buffer_size=8)
  return pipeline_module.MultiLabelDatasetBuilder(
      context, example, {t: t for t in TASKS}, hp, seed=3)


def _pipeline_model(pkg):
  if pkg == 'jax':
    return jax_models.RankingModel(
        scorer=jax_models.MultiTaskScorer(
            task_names=TASKS, body=jax_models.DNNScorer(
                hidden_layer_dims=HIDDEN, output_units=2, dropout=0.0,
                use_batch_norm=False)), transform_name='log1p')
  return scorers.RankingModel(scorers.MultiTaskScorer(
      TASKS, body=scorers.DNNScorer(HIDDEN, in_features=F, output_units=2,
                                    dropout=0.0, use_batch_norm=False)),
      transform_name='log1p')


def _log(model_dir):
  with open(os.path.join(model_dir, 'metrics.jsonl')) as f:
    return [json.loads(line) for line in f]


def test_multitask_pipeline_matches_the_jax_pipeline(files, tmp_path):
  jdir = str(tmp_path / 'jax')
  builder = _builder(jax_pipeline, jax_hparams, jax_parsers, files)
  model = _pipeline_model('jax')
  hp = jax_hparams.PipelineHparams(model_dir=jdir, mesh_data=1, **RUN)
  jax_pipeline.MultiTaskPipeline(model, builder, hp).train_and_validate()
  first = next(iter(builder.train_batches()))
  assert sorted(first.labels) == sorted(TASKS)
  initial = jax_train.create_train_state(
      model, optax.adam(hp.learning_rate), jax.random.PRNGKey(hp.seed),
      first.context, first.examples, first.mask)

  tmodel = _pipeline_model('port')
  tmodel.load_state_dict(convert.from_flax(
      jax.tree.map(np.asarray, {'params': initial.params})))
  tdir = str(tmp_path / 'port')
  pipe = pipeline.MultiTaskPipeline(
      tmodel, _builder(pipeline, hparams_lib, parsers, files),
      hparams_lib.PipelineHparams(model_dir=tdir, **RUN), device='cpu')
  assert sorted(pipe.metric_fns) == sorted(
      f'{t}/ndcg{s}' for t in TASKS for s in ('@1', '@5', '@10', ''))
  pipe.train_and_validate()
  want_log, got_log = _log(jdir), _log(tdir)
  assert [r['step'] for r in got_log] == [r['step'] for r in want_log] == [
      3, 6]
  names = ['loss', 'val_loss'] + sorted(pipe.metric_fns)
  for got, want in zip(got_log, want_log):
    for name in names:
      np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                 err_msg=f'step {got["step"]} {name}')
  assert (tmp_path / 'port' / 'export' / 'latest' / 'params.pt').exists()


def test_simple_pipeline_takes_a_dict_loss(files, tmp_path):
  """A dict ``hparams.loss`` builds one loss fn a task in SimplePipeline too,
  and the dict ``loss_weights`` reach the train and eval steps."""
  pipe = pipeline.SimplePipeline(
      _pipeline_model('port'), _builder(pipeline, hparams_lib, parsers,
                                        files),
      hparams_lib.PipelineHparams(model_dir=str(tmp_path), **RUN),
      metric_fns={'click/ndcg': metric_registry.make_ranking_metric_fn(
          'ndcg')}, device='cpu')
  assert sorted(pipe.loss_fn) == sorted(TASKS)
  assert pipe._task_weights == WEIGHTS
  history = pipe.train_and_validate()
  assert np.isfinite(history['loss']) and np.isfinite(history['val_loss'])
  with pytest.raises(ValueError, match='label_spec must map'):
    pipeline.MultiLabelDatasetBuilder({}, {}, {}, None)
  with pytest.raises(ValueError, match='missing from example_feature_spec'):
    pipeline.MultiLabelDatasetBuilder({}, {}, {'click': 'click'}, None)
