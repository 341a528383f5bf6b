"""PyTorch port's metrics == the JAX package's (atol 1e-6).

Every one of the 13 metric keys, weighted and unweighted, at topn None, 1
and 5; the ragged metric fns, ``compute_mean`` and ``eval_metric``. Inputs
are made with numpy from a seed and fed to both packages; the tolerance
covers float32 sums taken in another order.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ranking_tpu.ops import metric_registry as jax_registry
from ranking_tpu.utils import list_ops as jax_list_ops
from ranking_tpu_torch.ops import metric_registry
from ranking_tpu_torch.utils import list_ops

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

ATOL = 1e-6
# The new tests below also allow 1e-6 of the value: DCG, ARP and OPA's pair
# weights run past 1, where float32 sums in another order differ by a few
# ulps (1.9e-6 at 16) and an absolute 1e-6 is finer than the format.
RTOL = 1e-6
SUITE = [('ndcg', 1), ('ndcg', 5), ('ndcg', 10), ('ndcg', None),
         ('mrr', None)]


def _data(b=9, l=12, seed=0):
  rng = np.random.RandomState(seed)
  labels = rng.randint(0, 5, size=(b, l)).astype(np.float32)
  labels[rng.rand(b, l) < 0.25] = -1.0      # padded items
  labels[2] = -1.0                          # an all-invalid list
  labels[3] = np.where(labels[3] >= 0, 0.0, -1.0)  # no relevant item
  scores = rng.randn(b, l).astype(np.float32)
  scores[4, :4] = 0.5                       # score ties
  weights = rng.rand(b, l).astype(np.float32)
  weights[5] = 0.0                          # a weightless list
  return labels, scores, weights


@pytest.mark.parametrize('weighted', [False, True])
@pytest.mark.parametrize('key,topn', SUITE)
def test_metric_matches_jax(key, topn, weighted):
  labels, scores, weights = _data(seed=1)
  name = 'w' if weighted else None
  jfn = jax_registry.make_ranking_metric_fn(key, weights_feature_name=name,
                                            topn=topn)
  tfn = metric_registry.make_ranking_metric_fn(key, weights_feature_name=name,
                                               topn=topn)
  jv, jw = jfn(jnp.asarray(labels), jnp.asarray(scores),
               features={'w': jnp.asarray(weights)})
  tv, tw = tfn(torch.from_numpy(labels), torch.from_numpy(scores),
               features={'w': torch.from_numpy(weights)})
  np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)
  np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=ATOL, rtol=0)


def test_suite_in_shared_scope_matches_jax_and_shares_sorts():
  labels, scores, weights = _data(b=16, l=30, seed=2)
  jl, js = jnp.asarray(labels), jnp.asarray(scores)
  tl, ts = torch.from_numpy(labels), torch.from_numpy(scores)
  want, got = {}, {}
  with jax_list_ops.shared_sort_scope():
    for key, topn in SUITE:
      want[key, topn] = jax_registry.make_ranking_metric_fn(key, topn=topn)(
          jl, js)
  with list_ops.shared_sort_scope():
    for key, topn in SUITE:
      got[key, topn] = metric_registry.make_ranking_metric_fn(
          key, topn=topn)(tl, ts)
    # One predictions sort (labels + weights), one ideal sort per NDCG.
    sorted_channels = [v for k, v in list_ops.shared_sort_cache().items()
                       if k[0] != 'metric_prepare']
    assert len({(id(v[0]), id(v[1])) for v in sorted_channels}) == 5
  for k in SUITE:
    for g, w in zip(got[k], want[k]):
      np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


def test_mean_state_matches_jax():
  rng = np.random.RandomState(3)
  batches = [(rng.rand(6, 1).astype(np.float32),
              rng.rand(6).astype(np.float32)) for _ in range(3)]
  jstate = jax_registry.MeanState.zero()
  tstate = metric_registry.MeanState.zero('cpu')
  for values, weights in batches:
    jstate = jstate.update(jnp.asarray(values), jnp.asarray(weights))
    tstate = tstate.update(torch.from_numpy(values),
                           torch.from_numpy(weights))
  tstate = tstate.merge(metric_registry.MeanState.zero('cpu'))
  np.testing.assert_allclose(float(tstate.result()), float(jstate.result()),
                             atol=ATOL, rtol=0)
  assert float(metric_registry.MeanState.zero('cpu').result()) == 0.0
  with pytest.raises(ValueError, match='values vs'):
    tstate.update(torch.ones(6, 1), torch.ones(5))


def test_default_metric_fns_names_match_jax():
  assert (sorted(metric_registry.default_metric_fns())
          == sorted(jax_registry.default_metric_fns()))


def test_invalid_metric_key_raises():
  for registry in (metric_registry, jax_registry):
    with pytest.raises(ValueError, match='Invalid metric_key'):
      registry.build_metric('ndcgg')


def test_metric_keys_in_jax_order():
  assert (metric_registry.RankingMetricKey.all_keys()
          == jax_registry.RankingMetricKey.all_keys())
  assert len(metric_registry.RankingMetricKey.all_keys()) == 13


DIVERSITY = ('precision_ia', 'alpha_dcg')
ALL_KEYS = jax_registry.RankingMetricKey.all_keys()


def _subtopic_labels(b=9, l=12, s=3, seed=4):
  """[B, L, S] 0/1 subtopic labels; -1 pads whole items; one list has no
  relevant subtopic."""
  rng = np.random.RandomState(seed)
  labels = (rng.rand(b, l, s) < 0.3).astype(np.float32)
  labels[rng.rand(b, l) < 0.25] = -1.0
  labels[2] = -1.0
  labels[3] = np.where(labels[3] >= 0, 0.0, -1.0)
  return labels


def _key_inputs(key, weighted, seed=5):
  labels, scores, weights = _data(seed=seed)
  if key in DIVERSITY:
    labels = _subtopic_labels(seed=seed)
  if key == 'pwa':
    weights = weights[:, :1]   # PWA takes per-list weights
  features = {'w': weights} if weighted else {}
  return labels, scores, features


@pytest.mark.parametrize('weighted', [False, True])
@pytest.mark.parametrize('topn', [None, 1, 5])
@pytest.mark.parametrize('key', ALL_KEYS)
def test_every_key_matches_jax(key, topn, weighted):
  labels, scores, features = _key_inputs(key, weighted)
  name = 'w' if weighted else None
  jfn = jax_registry.make_ranking_metric_fn(key, weights_feature_name=name,
                                            topn=topn)
  tfn = metric_registry.make_ranking_metric_fn(key, weights_feature_name=name,
                                               topn=topn)
  jv, jw = jfn(jnp.asarray(labels), jnp.asarray(scores),
               features={k: jnp.asarray(v) for k, v in features.items()})
  tv, tw = tfn(torch.from_numpy(labels), torch.from_numpy(scores),
               features={k: torch.from_numpy(v) for k, v in features.items()})
  assert tuple(tv.shape) == np.shape(jv) and tuple(tw.shape) == np.shape(jw)
  np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=RTOL)
  np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=ATOL, rtol=RTOL)


def test_whole_suite_in_shared_scope_matches_jax():
  """All 13 keys in one scope, as the eval step runs them: the scope's
  cache keys keep PWA's mask sort and OPA's pairs apart from the rest."""
  labels, scores, _ = _data(b=16, l=30, seed=6)
  sub = _subtopic_labels(b=16, l=30, seed=6)
  inputs = {k: (sub if k in DIVERSITY else labels) for k in ALL_KEYS}
  want, got = {}, {}
  with jax_list_ops.shared_sort_scope():
    for key in ALL_KEYS:
      want[key] = jax_registry.make_ranking_metric_fn(key, topn=5)(
          jnp.asarray(inputs[key]), jnp.asarray(scores))
  with list_ops.shared_sort_scope():
    for key in ALL_KEYS:
      got[key] = metric_registry.make_ranking_metric_fn(key, topn=5)(
          torch.from_numpy(inputs[key]), torch.from_numpy(scores))
  for key in ALL_KEYS:
    for g, w in zip(got[key], want[key]):
      np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL,
                                 err_msg=key)


def test_metric_options_match_jax():
  labels, scores, _ = _data(seed=7)
  sub = _subtopic_labels(seed=7)
  for key, opts, data in (('alpha_dcg', {'alpha': 0.2}, sub),
                          ('bpref', {'use_trec_version': False}, labels)):
    want = jax_registry.compute_mean(key, jnp.asarray(data),
                                     jnp.asarray(scores), topn=5, **opts)
    got = metric_registry.compute_mean(key, torch.from_numpy(data),
                                       torch.from_numpy(scores), topn=5,
                                       **opts)
    np.testing.assert_allclose(float(got), float(want), atol=ATOL, rtol=RTOL)
  for registry in (metric_registry, jax_registry):
    with pytest.raises(ValueError, match='does not accept options'):
      registry.build_metric('ndcg', alpha=0.3)
    with pytest.raises(ValueError, match='PWA weights must be per-list'):
      registry.make_ranking_metric_fn('pwa', weights_feature_name='w')(
          labels, scores, features={'w': np.ones_like(scores)})
    with pytest.raises(ValueError, match='no topn cutoff'):
      registry.metrics_impl.ARPMetric(topn=3)
    with pytest.raises(ValueError, match='rank 3'):
      registry.build_metric('alpha_dcg')(labels, scores)


@pytest.mark.parametrize('key', ['ndcg', 'mrr', 'map', 'pwa'])
def test_ragged_metric_fn_matches_jax(key):
  rng = np.random.RandomState(8)
  lengths = [3, 7, 1, 5]
  labels = [rng.randint(0, 4, n).astype(float).tolist() for n in lengths]
  preds = [rng.randn(n).tolist() for n in lengths]
  weights = [rng.rand(n).tolist() for n in lengths]
  # Ragged weights densify to [B, L], which PWA refuses in both packages.
  name = None if key == 'pwa' else 'w'
  jfn = jax_registry.make_ranking_metric_fn(
      key, weights_feature_name=name, topn=3, ragged=True)
  tfn = metric_registry.make_ranking_metric_fn(
      key, weights_feature_name=name, topn=3, ragged=True)
  jv, jw = jfn(labels, preds, features={'w': weights})
  tv, tw = tfn(labels, preds, features={'w': weights})
  np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=RTOL)
  np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=ATOL, rtol=RTOL)
  dense = list_ops.ragged_to_dense(labels, preds, None, list_size=4)
  want = jax_list_ops.ragged_to_dense(labels, preds, None, list_size=4)
  for g, w in zip(dense, want):
    if w is None:
      assert g is None
    else:
      np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize('key', ['ndcg', 'precision', 'ordered_pair_accuracy'])
def test_compute_mean_and_eval_metric_match_jax(key):
  labels, scores, weights = _data(seed=9)
  want = jax_registry.compute_mean(key, jnp.asarray(labels),
                                   jnp.asarray(scores),
                                   weights=jnp.asarray(weights), topn=5)
  got = metric_registry.compute_mean(key, torch.from_numpy(labels),
                                     torch.from_numpy(scores),
                                     weights=torch.from_numpy(weights),
                                     topn=5)
  np.testing.assert_allclose(float(got), float(want), atol=ATOL, rtol=RTOL)
  jfn = jax_registry.make_ranking_metric_fn(key, topn=5)
  tfn = metric_registry.make_ranking_metric_fn(key, topn=5)
  want = jax_registry.eval_metric(jfn, labels=jnp.asarray(labels),
                                  predictions=jnp.asarray(scores))
  got = metric_registry.eval_metric(tfn, labels=torch.from_numpy(labels),
                                    predictions=torch.from_numpy(scores))
  np.testing.assert_allclose(float(got), float(want), atol=ATOL, rtol=RTOL)
  with pytest.raises(ValueError, match='requires argument predictions'):
    metric_registry.eval_metric(tfn, labels=torch.from_numpy(labels))
  with pytest.raises(ValueError, match='does not accept argument topn'):
    metric_registry.eval_metric(tfn, labels=torch.from_numpy(labels),
                                predictions=torch.from_numpy(scores), topn=3)
