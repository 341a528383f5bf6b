"""PyTorch port's NDCG / MRR metrics == the JAX package's (atol 1e-6).

Inputs are made with numpy from a seed and fed to both packages; the
tolerance covers float32 sums taken in another order.
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


@pytest.mark.parametrize('key', ['map', 'precision', 'arp'])
def test_unported_metric_raises(key):
  with pytest.raises(NotImplementedError, match='not ported yet'):
    metric_registry.build_metric(key)
  with pytest.raises(ValueError, match='Invalid metric_key'):
    metric_registry.build_metric('ndcgg')

