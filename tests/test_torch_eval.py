"""The port's evaluation surface == the JAX package's, on the CPU.

``PredictionAccumulator``, ``evaluate_dataset`` with query ids (some
queries split across lists) and a predictions CSV, and
``trec.evaluate_run`` over qrels and run files written from a seed, each
on the same numpy inputs and ``convert.from_flax`` weights as the JAX
package. Metrics to 1e-6 (float32 sums in another order); the CSV's query
ids and labels equal, its scores to 1e-5 (the logits' tolerance).
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ranking_tpu import models as jax_models
from ranking_tpu import ops as jax_ops
from ranking_tpu.data import batch as jax_batch
from ranking_tpu.data import trec as jax_trec
from ranking_tpu.ops import aggregated as jax_aggregated
from ranking_tpu.ops import metric_registry as jax_registry
from ranking_tpu.ops.pallas import sort as psort
from ranking_tpu.pipeline import serving as jax_serving
from ranking_tpu_torch import convert
from ranking_tpu_torch.data import batch as torch_batch
from ranking_tpu_torch.data import trec
from ranking_tpu_torch.models import scorers
from ranking_tpu_torch.ops import aggregated
from ranking_tpu_torch.ops import metric_registry
from ranking_tpu_torch.pipeline import serving
from ranking_tpu_torch.train import steps

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

B, L, F, HIDDEN = 4, 10, 6, (16, 8)
ATOL = 1e-6
SPECS = {'mrr': ('mrr', None), 'ndcg@5': ('ndcg', 5), 'map': ('map', None),
         'precision@3': ('precision', 3), 'opa': ('ordered_pair_accuracy',
                                                  None)}


def _models(seed=0):
  jmodel = jax_models.RankingModel(
      scorer=jax_models.DNNScorer(hidden_layer_dims=HIDDEN, dropout=0.0),
      transform_name='log1p')
  variables = jmodel.init(jax.random.PRNGKey(seed), {},
                          {'x': jnp.zeros((2, L, F))},
                          jnp.ones((2, L), bool), training=False)
  rng = np.random.RandomState(seed + 1)
  variables = jax.tree_util.tree_map_with_path(
      lambda p, x: (rng.uniform(0.5, 2.0, np.shape(x)) if 'var' in
                    jax.tree_util.keystr(p) else
                    np.asarray(x) + 0.3 * rng.randn(*np.shape(x))
                    ).astype(np.float32),
      jax.tree.map(np.asarray, dict(variables)))
  tmodel = scorers.RankingModel(scorers.DNNScorer(HIDDEN, in_features=F,
                                                  dropout=0.0),
                                transform_name='log1p')
  return jmodel, variables, tmodel, convert.from_flax(variables)


def _batches():
  """Three batches; query ids repeat across lists and batches."""
  rng = np.random.RandomState(3)
  qids = [[0, 1, 2, 0], [3, 1, 4, 5], [5, 6, 2, 7]]
  out = []
  for ids in qids:
    labels = rng.randint(0, 4, size=(B, L)).astype(np.float32)
    labels[rng.rand(B, L) < 0.3] = -1.0
    x = (rng.randn(B, L, F) * 3).astype(np.float32)
    qid = np.asarray(ids, np.int64)[:, None]
    out.append((jax_batch.batch_from_labels(
        jnp.asarray(labels), context={'qid': jnp.asarray(qid)},
        examples={'x': jnp.asarray(x)}),
                torch_batch.batch_from_labels(labels, context={'qid': qid},
                                              examples={'x': x})))
  return out


def _read_csv(path):
  with open(path) as f:
    rows = list(csv.reader(f))
  return rows[0], np.asarray([[float(v) for v in r] for r in rows[1:]])


def test_prediction_accumulator_matches_jax():
  rng = np.random.RandomState(4)
  want, got = jax_aggregated.PredictionAccumulator(), \
      aggregated.PredictionAccumulator()
  for qids in ([0, 1, 0], [2, 1, 3]):
    labels = rng.randint(-1, 4, size=(3, 5)).astype(np.float32)
    scores = rng.randn(3, 5).astype(np.float32)
    want.add_batch(np.asarray(qids), labels, scores)
    got.add_batch(np.asarray(qids), labels, scores)
  for g, w in zip(got.grouped(), want.grouped()):
    np.testing.assert_array_equal(g, w)
  a = got.compute(SPECS, device='cpu')
  b = want.compute(SPECS)
  assert list(a) == list(b)
  np.testing.assert_allclose(list(a.values()), list(b.values()), atol=ATOL,
                             rtol=0)


def test_evaluate_dataset_query_ids_and_csv_match_jax(tmp_path):
  jmodel, variables, tmodel, state = _models()
  batches = _batches()
  want = jax_serving.evaluate_dataset(
      jmodel, variables, [jb for jb, _ in batches],
      metric_fns={k: jax_registry.make_ranking_metric_fn(key, topn=n)
                  for k, (key, n) in SPECS.items()},
      query_id_feature='qid', aggregated_metrics=SPECS,
      predictions_csv=str(tmp_path / 'jax.csv'))
  got = serving.evaluate_dataset(
      tmodel, state, [tb for _, tb in batches],
      metric_fns={k: metric_registry.make_ranking_metric_fn(key, topn=n)
                  for k, (key, n) in SPECS.items()},
      query_id_feature='qid', aggregated_metrics=SPECS,
      predictions_csv=str(tmp_path / 'torch.csv'), device='cpu')
  assert sorted(got) == sorted(want)
  assert sum(k.startswith('agg/') for k in got) == len(SPECS)
  for k in want:
    np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0, err_msg=k)
  jhead, jrows = _read_csv(tmp_path / 'jax.csv')
  thead, trows = _read_csv(tmp_path / 'torch.csv')
  assert thead == jhead == ['query_id', 'relevance', 'score']
  assert trows.shape == jrows.shape
  np.testing.assert_array_equal(trows[:, :2], jrows[:, :2])
  np.testing.assert_allclose(trows[:, 2], jrows[:, 2], atol=1e-5, rtol=0)


def test_evaluate_dataset_query_id_errors():
  _, _, tmodel, state = _models()
  _, tb = _batches()[0]
  with pytest.raises(ValueError, match="query_id_feature 'qq' not in batch"):
    serving.evaluate_dataset(tmodel, state, [tb], query_id_feature='qq',
                             device='cpu')

  class TwoTasks(torch.nn.Module):
    def forward(self, context, examples, mask, training=False):
      return {'a': examples['x'][..., 0], 'b': examples['x'][..., 1]}

  fns = {'a': lambda labels, logits, features=None: (
      torch.zeros(labels.shape[0], 1), torch.ones(labels.shape[0], 1))}
  with pytest.raises(ValueError, match='single-task logits'):
    serving.evaluate_dataset(TwoTasks(), None, [tb], metric_fns=fns,
                             query_id_feature='qid', device='cpu')


def test_graphed_eval_step_is_the_eager_step_on_the_cpu():
  _, _, tmodel, state = _models()
  tmodel.load_state_dict(state)
  fns = {k: metric_registry.make_ranking_metric_fn(key, topn=n)
         for k, (key, n) in SPECS.items()}
  eager = steps.make_eval_step(fns, device='cpu')
  graphed = steps.GraphedEvalStep(eager, device='cpu')
  _, tb = _batches()[1]
  tb = tb.replace(context={})
  a, la = graphed(tmodel, tb, steps.init_metric_states(fns, device='cpu'),
                  num_valid_rows=3)
  b, lb = eager(tmodel, tb, steps.init_metric_states(fns, device='cpu'),
                num_valid_rows=3)
  assert torch.equal(la, lb) and graphed.captures == 0
  for k in fns:
    assert torch.equal(a[k].total, b[k].total)
    assert torch.equal(a[k].count, b[k].count)


def _write_trec(tmp_path, seed=5, queries=30):
  """qrels of 3-20 judged documents a query; a run that drops some judged
  documents, adds unjudged ones, repeats one and ties some scores."""
  rng = np.random.RandomState(seed)
  qrels, run = tmp_path / 'qrels.txt', tmp_path / 'run.txt'
  with open(qrels, 'w') as fq, open(run, 'w') as fr:
    for q in range(queries):
      n = rng.randint(3, 21)
      docs = [f'd{q}_{i}' for i in range(n)]
      for d in docs:
        fq.write(f'q{q} 0 {d} {rng.randint(0, 5)}\n')
      retrieved = [d for d in docs if rng.rand() > 0.2]
      retrieved += [f'x{q}_{i}' for i in range(rng.randint(0, 4))]
      if retrieved:
        retrieved.append(retrieved[0])   # a repeat keeps its first score
      rng.shuffle(retrieved)
      for rank, d in enumerate(retrieved, 1):
        score = round(rng.randn(), 1)       # one decimal: ties
        fr.write(f'q{q} Q0 {d} {rank} {score} test\n')
  return str(qrels), str(run)


@pytest.fixture
def jax_kernel_sort():
  """The JAX package's sort kernel (interpret mode): the rounded scores
  hold -0.0 beside +0.0, which the kernel and the port rank as a tie (by
  position) and ``lax.top_k``, the JAX package's other path, apart."""
  prev_enabled, prev_interpret = jax_ops.pallas._ENABLED, psort._INTERPRET
  jax_ops.pallas.set_enabled(True)
  psort._INTERPRET = True
  yield
  jax_ops.pallas.set_enabled(prev_enabled)
  psort._INTERPRET = prev_interpret


def test_evaluate_run_matches_jax(tmp_path, jax_kernel_sort):
  qrels, run = _write_trec(tmp_path)
  spec = 'ndcg@5,ndcg,mrr,mrr@10:rel>=3,map,precision@3,hits@1,arp'
  want = jax_trec.evaluate_run(qrels, run, spec, batch_size=8)
  got = trec.evaluate_run(qrels, run, spec, batch_size=8, device='cpu')
  assert list(got) == list(want)
  for k in want:
    np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=1e-6,
                               err_msg=k)
  # The pieces: join order, buckets, specs, write/read round trip.
  jl = list(jax_trec.merged_lists(jax_trec.read_qrels(qrels),
                                  jax_trec.read_run(run)))
  tl = list(trec.merged_lists(trec.read_qrels(qrels), trec.read_run(run)))
  assert [q for q, _, _ in tl] == [q for q, _, _ in jl]
  for (_, a, b), (_, c, d) in zip(tl, jl):
    np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(b, d)
  for (a, b), (c, d) in zip(trec.padded_batches(iter(tl), 8),
                            jax_trec.padded_batches(iter(jl), 8)):
    np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(b, d)
  assert [trec._bucket(n) for n in (1, 8, 9, 33)] == [8, 8, 16, 64]
  assert trec.parse_metric_specs(spec) == [
      trec.MetricSpec(s.key, s.topn, s.threshold)
      for s in jax_trec.parse_metric_specs(spec)]
  out = str(tmp_path / 'written.txt')
  trec.write_run(out, {'q1': {'a': 0.5, 'b': 1.5}})
  assert trec.read_run(out) == {'q1': [('b', 1.5), ('a', 0.5)]}


def test_trec_errors_match_jax(tmp_path):
  bad = tmp_path / 'bad.txt'
  bad.write_text('q1 0 d1\n')
  for pkg in (trec, jax_trec):
    with pytest.raises(ValueError, match='expected 4 fields'):
      pkg.read_qrels(str(bad))
    with pytest.raises(ValueError, match='expected 6 fields'):
      pkg.read_run(str(bad))
    with pytest.raises(ValueError, match='Unknown metric key'):
      pkg.parse_metric_specs('ndcgg@5')
    with pytest.raises(ValueError, match='Bad metric condition'):
      pkg.parse_metric_specs('mrr:rel>3')
  qrels, run = _write_trec(tmp_path, queries=3)
  with pytest.raises(ValueError, match='Duplicate metric spec'):
    trec.evaluate_run(qrels, run, 'mrr,mrr', device='cpu')
  with pytest.raises(ValueError, match='no metrics requested'):
    trec.evaluate_run(qrels, run, '', device='cpu')
