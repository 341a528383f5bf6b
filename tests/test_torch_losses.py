"""The port's reductions, SoftmaxLoss and loss factory == the JAX package's.

Labels, logits and item weights come from numpy with a seed and go through
both; values and the gradient of the logits are compared (rtol 1e-5, atol
1e-6: float32 log-softmax sums in another order). The batch has an
all-zero-label list, a padded list (labels -1) and an all-padding list.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ranking_tpu.ops import loss_registry as jax_registry
from ranking_tpu.ops import losses as jax_losses
from ranking_tpu.ops import reductions as jax_reductions
from ranking_tpu_torch.ops import loss_registry, losses, reductions

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

B, L = 6, 8
RTOL, ATOL = 1e-5, 1e-6
REDUCTIONS = ['sum', 'mean', 'sum_over_batch_size', 'sum_by_nonzero_weights']


def _data(seed=0):
  rng = np.random.RandomState(seed)
  labels = rng.randint(0, 5, (B, L)).astype(np.float32)
  labels[1] = 0.0            # a list with no relevant document
  labels[2, 5:] = -1.0       # a padded list
  labels[3] = -1.0           # an all-padding list
  logits = (rng.randn(B, L) * 2).astype(np.float32)
  weights = rng.uniform(0.5, 2.0, (B, L)).astype(np.float32)
  return labels, logits, weights


def _value_and_grad_jax(fn, logits):
  value, grad = jax.value_and_grad(fn)(jnp.asarray(logits))
  return np.asarray(value), np.asarray(grad)


def _value_and_grad_torch(fn, logits):
  t = torch.from_numpy(logits.copy()).requires_grad_()
  value = fn(t)
  value.backward()
  return value.detach().numpy(), t.grad.numpy()


@pytest.mark.parametrize('reduction', REDUCTIONS + ['none'])
@pytest.mark.parametrize('weighted', [True, False])
def test_reduce_weighted_matches_jax(reduction, weighted):
  labels, logits, weights = _data()
  w = weights[:, :1] * (labels[:, :1] > 0) if weighted else None
  want = jax_reductions.reduce_weighted(
      jnp.asarray(logits), None if w is None else jnp.asarray(w), reduction)
  got = reductions.reduce_weighted(
      torch.from_numpy(logits), None if w is None else torch.from_numpy(w),
      reduction)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                             atol=ATOL)


def test_reduce_terms_and_zero_denominator():
  losses_ = torch.ones(3, 1)
  num, den = reductions.reduce_terms(losses_, torch.zeros(3, 1), 'mean')
  assert num.item() == 0 and den.item() == 0
  assert reductions.reduce_weighted(losses_, torch.zeros(3, 1)).item() == 0
  with pytest.raises(ValueError):
    reductions.reduce_terms(losses_, None, 'none')


@pytest.mark.parametrize('reduction', REDUCTIONS)
@pytest.mark.parametrize('weighted', [True, False])
def test_softmax_loss_matches_jax(reduction, weighted):
  labels, logits, weights = _data(1)
  w = weights if weighted else None
  jloss = jax_losses.SoftmaxLoss(temperature=2.0)
  tloss = losses.SoftmaxLoss(temperature=2.0)
  want = _value_and_grad_jax(
      lambda s: jloss(jnp.asarray(labels), s,
                      weights=None if w is None else jnp.asarray(w),
                      reduction=reduction), logits)
  got = _value_and_grad_torch(
      lambda s: tloss(torch.from_numpy(labels), s,
                      weights=None if w is None else torch.from_numpy(w),
                      reduction=reduction), logits)
  for g, wnt in zip(got, want):
    np.testing.assert_allclose(g, wnt, rtol=RTOL, atol=ATOL)


def test_softmax_per_list_and_label_distribution_match_jax():
  labels, logits, weights = _data(2)
  want = jax_losses.SoftmaxLoss().per_list(
      jnp.asarray(labels), jnp.asarray(logits), weights=jnp.asarray(weights))
  got = losses.SoftmaxLoss().per_list(
      torch.from_numpy(labels), torch.from_numpy(logits),
      weights=torch.from_numpy(weights))
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
  mask = labels >= 0
  want = jax_losses._label_distribution(jnp.asarray(np.where(mask, labels, 0)),
                                        jnp.asarray(mask))
  got = losses._label_distribution(
      torch.from_numpy(np.where(mask, labels, 0).astype(np.float32)),
      torch.from_numpy(mask))
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=1e-12)
  # The all-zero list spreads EPSILON evenly; the all-padding list is 0.
  np.testing.assert_allclose(got[0][1].numpy(), np.full(L, 1 / L), rtol=1e-6)
  assert torch.all(got[0][3] == 0)


def test_listwise_normalize_weights_matches_jax():
  labels, _, weights = _data(3)
  want = jax_losses._ListwiseLoss().normalize_weights(
      jnp.asarray(labels), jnp.asarray(weights))
  got = losses._ListwiseLoss().normalize_weights(
      torch.from_numpy(labels), torch.from_numpy(weights))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                             atol=ATOL)
  assert losses._ListwiseLoss().normalize_weights(None, None) == 1.0


@pytest.mark.parametrize('config', [
    dict(loss_keys='softmax_loss'),
    dict(loss_keys='softmax_loss:0.7'),
    dict(loss_keys=['softmax_loss', 'softmax_loss'], loss_weights=[0.3, 1.5]),
    dict(loss_keys='softmax_loss', weights_feature_name='w'),
    dict(loss_keys='softmax_loss', reduction='mean',
         params={'temperature': 0.5}),
])
def test_make_loss_fn_matches_jax(config):
  labels, logits, weights = _data(4)
  jfn = jax_registry.make_loss_fn(**config)
  tfn = loss_registry.make_loss_fn(**config)
  want = _value_and_grad_jax(
      lambda s: jfn(jnp.asarray(labels), s,
                    features={'w': jnp.asarray(weights)}), logits)
  got = _value_and_grad_torch(
      lambda s: tfn(torch.from_numpy(labels), s,
                    features={'w': torch.from_numpy(weights)}), logits)
  for g, w in zip(got, want):
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_make_loss_metric_fn_matches_jax():
  labels, logits, weights = _data(5)
  want = jax_registry.make_loss_metric_fn(
      'softmax_loss', weights_feature_name='w')(
          jnp.asarray(labels), jnp.asarray(logits),
          features={'w': jnp.asarray(weights)})
  got = loss_registry.make_loss_metric_fn(
      'softmax_loss', weights_feature_name='w')(
          torch.from_numpy(labels), torch.from_numpy(logits),
          features={'w': torch.from_numpy(weights)})
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_factory_refuses_what_is_not_ported():
  assert (loss_registry.RankingLossKey.all_keys()
          == jax_registry.RankingLossKey.all_keys())
  with pytest.raises(NotImplementedError, match='not ported yet'):
    loss_registry.make_loss_fn('pairwise_logistic_loss')
  with pytest.raises(NotImplementedError, match='not ported yet'):
    loss_registry.make_loss_fn('softmax_loss', lambda_weight=object())
  with pytest.raises(ValueError, match='Invalid loss_key'):
    loss_registry.make_loss_fn('no_such_loss')
  with pytest.raises(ValueError, match='NONE'):
    loss_registry.make_loss_fn('softmax_loss', reduction='none')
  with pytest.raises(ValueError, match='same size'):
    loss_registry.make_loss_fn(['softmax_loss'], loss_weights=[1.0, 2.0])
  with pytest.raises(ValueError, match='must be None'):
    loss_registry.make_loss_fn('softmax_loss:1.0', loss_weights=[1.0])
  fn = loss_registry.make_loss_fn('softmax_loss', weights_feature_name='w')
  with pytest.raises(ValueError, match="must contain 'w'"):
    fn(torch.zeros(1, 2), torch.zeros(1, 2), features={})
