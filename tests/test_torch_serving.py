"""PyTorch port's serving and eval path == the JAX package's.

``Predictor.score_batch``, ``evaluate_dataset`` and ``make_eval_step`` (a
flat-fed batch padded with ``pad_to``, ``num_valid_rows``, a val loss) are
held against ``ranking_tpu.pipeline.serving`` and
``ranking_tpu.train.make_eval_step`` on the same numpy batches and carried
weights. JAX runs once on its default XLA sort and once with the Pallas
sort kernel forced in interpret mode. ``Predictor.predict`` and
``regress`` are held against the JAX ``Predictor`` on the same serialized
requests. Tolerances: logits 1e-5, metrics 1e-6.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ranking_tpu import ops as jax_ops
from ranking_tpu import train as jax_train
from ranking_tpu.data import batch as jax_batch
from ranking_tpu.data import dataset as jax_dataset
from ranking_tpu.data import parsers as jax_parsers
from ranking_tpu.models import scorers as jax_scorers
from ranking_tpu.ops import metric_registry as jax_registry
from ranking_tpu.ops.pallas import sort as psort
from ranking_tpu.pipeline import serving as jax_serving
from ranking_tpu_torch import convert
from ranking_tpu_torch.data import batch as torch_batch
from ranking_tpu_torch.data import dataset as torch_dataset
from ranking_tpu_torch.data import parsers
from ranking_tpu_torch.data import proto as torch_proto
from ranking_tpu_torch.models import scorers
from ranking_tpu_torch.ops import metric_registry
from ranking_tpu_torch.pipeline import serving
from ranking_tpu_torch.train import checkpoint
from ranking_tpu_torch.train import steps

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

B, L, F, HIDDEN = 4, 10, 6, (16, 8)
SUITE = [('ndcg', 1), ('ndcg', 5), ('ndcg', 10), ('ndcg', None),
         ('mrr', None)]


@pytest.fixture(params=['xla_sort', 'pallas_sort'])
def jax_sort_path(request):
  prev_enabled, prev_interpret = jax_ops.pallas._ENABLED, psort._INTERPRET
  if request.param == 'pallas_sort':
    jax_ops.pallas.set_enabled(True)
    psort._INTERPRET = True
  yield request.param
  jax_ops.pallas.set_enabled(prev_enabled)
  psort._INTERPRET = prev_interpret


def _arrays(seed, b=B):
  rng = np.random.RandomState(seed)
  labels = rng.randint(0, 5, size=(b, L)).astype(np.float32)
  labels[rng.rand(b, L) < 0.3] = -1.0
  labels[1] = -1.0  # an all-invalid list
  examples = (rng.randn(b, L, F) * 4).astype(np.float32)
  weights = rng.rand(b, L).astype(np.float32)
  return labels, {'x': examples, 'w': weights}


def _model_pair(seed=0):
  labels, examples = _arrays(seed)
  jmodel = jax_scorers.RankingModel(
      scorer=jax_scorers.DNNScorer(hidden_layer_dims=HIDDEN),
      transform_name='log1p')
  feats = {'x': jnp.asarray(examples['x'])}
  variables = jmodel.init(jax.random.PRNGKey(seed), {}, feats,
                          jnp.asarray(labels >= 0), training=False)
  rng = np.random.RandomState(seed + 1)
  variables = jax.tree_util.tree_map_with_path(
      lambda p, x: (rng.uniform(0.5, 2.0, np.shape(x)) if 'var' in
                    jax.tree_util.keystr(p) else
                    np.asarray(x) + 0.3 * rng.randn(*np.shape(x))
                    ).astype(np.float32),
      jax.tree.map(np.asarray, dict(variables)))
  tmodel = scorers.RankingModel(scorers.DNNScorer(HIDDEN, in_features=F),
                                transform_name='log1p')
  return jmodel, variables, tmodel, convert.from_flax(variables)


class _ExampleFeature(torch.nn.Module):
  """Scores only the 'x' feature: 'w' is a metric weight, not an input."""

  def __init__(self, model):
    super().__init__()
    self.model = model

  def forward(self, context, examples, mask, training=False):
    return self.model(context, {'x': examples['x']}, mask, training=training)


def _jax_apply_x(jmodel):
  class _Wrapped:
    def apply(self, variables, context, examples, mask, **kw):
      return jmodel.apply(variables, context, {'x': examples['x']}, mask,
                          **kw)
  return _Wrapped()


def _batches(n=3):
  out = []
  for seed in range(10, 10 + n):
    labels, examples = _arrays(seed)
    out.append((jax_batch.batch_from_labels(
        jnp.asarray(labels),
        examples={k: jnp.asarray(v) for k, v in examples.items()}),
                torch_batch.batch_from_labels(labels, examples=examples)))
  return out


def _suite(registry, weighted):
  name = 'w' if weighted else None
  return {f'{k}_{n}': registry.make_ranking_metric_fn(
      k, weights_feature_name=name, topn=n) for k, n in SUITE}


def test_score_batch_matches_jax():
  jmodel, variables, tmodel, state = _model_pair()
  labels, examples = _arrays(3, b=7)
  jb = jax_batch.batch_from_labels(jnp.asarray(labels),
                                   examples={'x': jnp.asarray(examples['x'])})
  tb = torch_batch.batch_from_labels(labels, examples={'x': examples['x']})
  want = jax_serving.Predictor(jmodel, variables, {}, {}).score_batch(jb)
  got = serving.Predictor(tmodel, state, device='cpu').score_batch(tb)
  assert got.shape == (7, L) and got.dtype == np.float32
  np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_evaluate_dataset_weighted_matches_jax(jax_sort_path):
  jmodel, variables, tmodel, state = _model_pair()
  batches = _batches()
  want = jax_serving.evaluate_dataset(
      _jax_apply_x(jmodel), variables, [jb for jb, _ in batches],
      metric_fns=_suite(jax_registry, weighted=True))
  got = serving.evaluate_dataset(
      _ExampleFeature(tmodel), {f'model.{k}': v for k, v in state.items()},
      [tb for _, tb in batches],
      metric_fns=_suite(metric_registry, weighted=True), device='cpu')
  assert sorted(got) == sorted(want)
  for k in want:
    np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0,
                               err_msg=k)


def test_evaluate_dataset_default_suite_matches_jax():
  jmodel, variables, tmodel, state = _model_pair()
  batches = [(jb.replace(examples={'x': jb.examples['x']}),
              tb.replace(examples={'x': tb.examples['x']}))
             for jb, tb in _batches(2)]
  want = jax_serving.evaluate_dataset(jmodel, variables,
                                      [jb for jb, _ in batches])
  got = serving.evaluate_dataset(tmodel, state, [tb for _, tb in batches],
                                 device='cpu')
  assert sorted(got) == sorted(want) == ['mrr', 'ndcg@5']
  for k in want:
    np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0)


def _jax_loss(labels, logits, features=None, key=None):
  mask = labels >= 0
  return jnp.sum(jnp.where(mask, (logits - labels) ** 2, 0.0)) / jnp.maximum(
      jnp.sum(mask), 1)


def _torch_loss(labels, logits, features=None):
  mask = labels >= 0
  return torch.sum(torch.where(mask, (logits - labels) ** 2, 0.0)) / (
      torch.clamp(torch.sum(mask), min=1))


def test_eval_step_flat_padded_matches_jax(jax_sort_path):
  jmodel, variables, tmodel, state = _model_pair()
  tmodel.load_state_dict(state)
  jb, tb = _batches(1)[0]
  jb = jax_dataset.flatten_examples(
      jb.replace(examples={'x': jb.examples['x']}).pad_to(B + 2))
  tb = torch_dataset.flatten_examples(
      tb.replace(examples={'x': tb.examples['x']}).pad_to(B + 2))
  assert tuple(tb.examples['x'].shape) == ((B + 2) * L, F)
  assert tb.labels[B:].eq(-1).all() and not tb.mask[B:].any()

  jfns, tfns = _suite(jax_registry, False), _suite(metric_registry, False)
  jstep = jax.jit(jax_train.make_eval_step(jfns, loss_fn=_jax_loss))
  jstate = jax_train.TrainState(
      step=jnp.zeros((), jnp.int32), params=variables['params'],
      batch_stats=variables['batch_stats'], opt_state=(),
      tx=optax.identity(), apply_fn=jmodel.apply)
  jstates, jlogits = jstep(jstate, jb,
                           jax_train.init_metric_states(jfns, with_loss=True),
                           num_valid_rows=B)
  tstep = steps.make_eval_step(tfns, loss_fn=_torch_loss, device='cpu')
  tstates, tlogits = tstep(
      tmodel, tb, steps.init_metric_states(tfns, with_loss=True, device='cpu'),
      num_valid_rows=B)
  np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-5,
                             rtol=0)
  want = jax_train.metric_results(jstates)
  got = steps.metric_results(tstates)
  assert sorted(got) == sorted(want)
  for k in want:
    # Metrics at atol 1e-6; the loss (a sum of squares near 1e2) at one
    # float32 ulp, rtol 1e-6.
    tol = dict(atol=0, rtol=1e-6) if k == 'loss' else dict(atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k,
                               **tol)
    np.testing.assert_allclose(float(tstates[k].count),
                               float(jstates[k].count), atol=1e-6, err_msg=k)


def test_restore_flat_examples_mirrors_jax_predicate():
  # Any leaf whose leading axis is B*L is restored, whatever its rank (the
  # JAX package's predicate, mirrored as is).
  labels, _ = _arrays(0)
  odd = np.arange(B * L, dtype=np.float32)
  jb = jax_batch.batch_from_labels(jnp.asarray(labels),
                                   examples={'odd': jnp.asarray(odd)})
  tb = torch_batch.batch_from_labels(labels, examples={'odd': odd})
  want = jax_train.steps.restore_flat_examples(jb).examples['odd']
  got = steps.restore_flat_examples(tb).examples['odd']
  assert tuple(got.shape) == want.shape == (B, L)


def test_eval_step_rejects_reserved_loss_name():
  with pytest.raises(ValueError, match='reserved'):
    steps.make_eval_step({'loss': None}, loss_fn=_torch_loss, device='cpu')


# --- serialized requests: predict and regress --------------------------------


def _request_specs(pkg):
  return {'x': pkg.FixedLenFeature((F,), 'float32', 0.0),
          'relevance': pkg.FixedLenFeature((), 'int64', 0)}


def _elwcs(seed, lengths):
  rng = np.random.RandomState(seed)
  return [torch_proto.make_elwc({}, [
      {'x': (rng.randn(F) * 4).astype(np.float32),
       'relevance': [int(rng.randint(0, 5))]} for _ in range(n)])
      for n in lengths]


def _predictors(list_size=None):
  jmodel, variables, tmodel, state = _model_pair()
  want = jax_serving.Predictor(jmodel, variables, {},
                               _request_specs(jax_parsers),
                               list_size=list_size,
                               label_feature_name='relevance')
  got = serving.Predictor(tmodel, state, {}, _request_specs(parsers),
                          list_size=list_size,
                          label_feature_name='relevance', device='cpu')
  return want, got


@pytest.mark.parametrize('list_size', [None, 10])
def test_predict_matches_jax(list_size):
  """Logits at test_score_batch_matches_jax's tolerance, 1e-5; padded
  slots at the sentinel in both."""
  want_predictor, predictor = _predictors(list_size)
  assert 'relevance' not in predictor.example_feature_spec
  requests = _elwcs(5, [3, 12, 1, 7])
  want = want_predictor.predict(requests)
  got = predictor.predict(requests)
  assert got.shape == want.shape == (4, list_size or 12)
  assert got.dtype == np.float32
  np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
  assert (got[0, 3:] == np.float32(np.log(1e-10))).all()


def test_regress_matches_jax_and_predict():
  """regress on tf.Examples == predict on the same documents as lists of
  one (python/keras/pipeline_test.py:238), and == the JAX Predictor."""
  want_predictor, predictor = _predictors()
  rng = np.random.RandomState(6)
  docs = [{'x': (rng.randn(F) * 4).astype(np.float32), 'relevance': [1]}
          for _ in range(5)]
  examples = [torch_proto.make_example(d) for d in docs]
  lists = [torch_proto.make_elwc({}, [d]) for d in docs]
  got = predictor.regress(examples)
  assert got.shape == (5,)
  np.testing.assert_allclose(got, want_predictor.regress(examples),
                             atol=1e-5, rtol=0)
  np.testing.assert_array_equal(got, predictor.predict(lists)[:, 0])
  assert predictor.predict(lists).shape == (5, 1)


def test_empty_requests_and_buckets():
  _, predictor = _predictors()
  assert predictor.predict([]).shape == (0, 1)
  assert predictor.regress([]).shape == (0,)
  assert _predictors(7)[1].predict([]).shape == (0, 7)
  for longest, bucket in ((1, 1), (5, 6), (13, 16), (25, 32)):
    assert predictor.predict(_elwcs(7, [1, longest])).shape == (2, bucket)


def test_from_export_scores_as_the_exported_model(tmp_path):
  _, predictor = _predictors()
  export = str(tmp_path / 'export')
  checkpoint.export_params(types.SimpleNamespace(model=predictor.model),
                           export)
  _, _, fresh, _ = _model_pair(seed=3)
  loaded = serving.Predictor.from_export(
      fresh, export, {}, _request_specs(parsers),
      label_feature_name='relevance', device='cpu')
  requests = _elwcs(8, [4, 9])
  np.testing.assert_array_equal(loaded.predict(requests),
                                predictor.predict(requests))
