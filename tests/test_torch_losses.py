"""The port's reductions, losses and loss factory == the JAX package's.

Labels, logits and item weights come from numpy with a seed and go through
both; values and the gradient of the logits are compared (rtol 1e-5, atol
1e-6: float32 log-softmax sums, and pairwise sums over L^2 terms, in
another order). The batch has an all-zero-label list, a padded list
(labels -1) and an all-padding list. The pairwise losses take their plain
``[B, L, L]`` path here (the CPU default), the JAX package its jnp path
(its default off the TPU); ``tests/test_torch_pairwise.py`` holds the fused
sums.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ranking_tpu.ops import lambda_weights as jax_lw
from ranking_tpu.ops import loss_registry as jax_registry
from ranking_tpu.ops import losses as jax_losses
from ranking_tpu.ops import reductions as jax_reductions
from ranking_tpu_torch.ops import lambda_weights as lw
from ranking_tpu_torch.ops import loss_registry, losses, reductions
from ranking_tpu_torch.ops.cuda import pairwise as cuda_pairwise

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
    dict(loss_keys='pairwise_logistic_loss'),
    dict(loss_keys='pairwise_hinge_loss', weights_feature_name='w',
         lambda_weight='label_diff'),
    dict(loss_keys='pairwise_soft_zero_one_loss', reduction='sum',
         lambda_weight='ndcg_v2'),
    dict(loss_keys='pairwise_mse_loss', reduction='mean'),
    dict(loss_keys='pairwise_logistic_loss', lambda_weight='ndcg',
         weights_feature_name='w', params={'temperature': 2.0}),
    dict(loss_keys='pairwise_logistic_loss', lambda_weight='no_lambda'),
    dict(loss_keys='softmax_loss:0.5,pairwise_logistic_loss:2.0',
         lambda_weight='ndcg'),
])
def test_make_loss_fn_matches_jax(config):
  labels, logits, weights = _data(4)
  name = config.get('lambda_weight')
  jconfig, tconfig = dict(config), dict(config)
  if name in _LAMBDA_WEIGHTS:
    jconfig['lambda_weight'], tconfig['lambda_weight'] = _LAMBDA_WEIGHTS[name]
  jfn = jax_registry.make_loss_fn(**jconfig)
  tfn = loss_registry.make_loss_fn(**tconfig)
  want = _value_and_grad_jax(
      lambda s: jfn(jnp.asarray(labels), s,
                    features={'w': jnp.asarray(weights)}), logits)
  got = _value_and_grad_torch(
      lambda s: tfn(torch.from_numpy(labels), s,
                    features={'w': torch.from_numpy(weights)}), logits)
  for g, w in zip(got, want):
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('loss_key,lambda_name', [
    ('softmax_loss', None), ('softmax_loss', 'ndcg'),
    ('pairwise_logistic_loss', None), ('pairwise_hinge_loss', 'ndcg'),
    ('pairwise_mse_loss', 'label_diff')])
def test_make_loss_metric_fn_matches_jax(loss_key, lambda_name):
  labels, logits, weights = _data(5)
  jlam, tlam = _LAMBDA_WEIGHTS.get(lambda_name, (None, None))
  want = jax_registry.make_loss_metric_fn(
      loss_key, weights_feature_name='w', lambda_weight=jlam)(
          jnp.asarray(labels), jnp.asarray(logits),
          features={'w': jnp.asarray(weights)})
  got = loss_registry.make_loss_metric_fn(
      loss_key, weights_feature_name='w', lambda_weight=tlam)(
          torch.from_numpy(labels), torch.from_numpy(logits),
          features={'w': torch.from_numpy(weights)})
  for g, w in zip(got, want):
    assert g.shape == w.shape
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


# (JAX weight, port weight) by name.
_LAMBDA_WEIGHTS = {
    'label_diff': (jax_lw.LabelDiffLambdaWeight(), lw.LabelDiffLambdaWeight()),
    'ndcg': (jax_lw.create_ndcg_lambda_weight(),
             lw.create_ndcg_lambda_weight()),
    'ndcg_top3_smooth': (
        jax_lw.create_ndcg_lambda_weight(topn=3, smooth_fraction=0.3),
        lw.create_ndcg_lambda_weight(topn=3, smooth_fraction=0.3)),
    'ndcg_v2': (jax_lw.create_ndcg_lambda_weight_v2(topn=4),
                lw.create_ndcg_lambda_weight_v2(topn=4)),
    'yeti': (jax_lw.create_yeti_dcg_lambda_weight(),
             lw.create_yeti_dcg_lambda_weight()),
    'precision': (jax_lw.PrecisionLambdaWeight(topn=3),
                  lw.PrecisionLambdaWeight(topn=3)),
}
_PAIRWISE = ['PairwiseLogisticLoss', 'PairwiseHingeLoss',
             'PairwiseSoftZeroOneLoss', 'PairwiseMSELoss']


@pytest.mark.parametrize('reduction', REDUCTIONS)
@pytest.mark.parametrize('inputs', ['plain', 'weighted', 'masked'])
@pytest.mark.parametrize('cls', _PAIRWISE)
def test_pairwise_loss_matches_jax(cls, inputs, reduction):
  labels, logits, weights = _data(6)
  w = weights if inputs == 'weighted' else None
  mask = (labels >= 1) if inputs == 'masked' else None
  jloss = getattr(jax_losses, cls)(temperature=1.5)
  tloss = getattr(losses, cls)(temperature=1.5)
  opt = lambda a, conv: None if a is None else conv(a)  # noqa: E731
  want = _value_and_grad_jax(
      lambda s: jloss(jnp.asarray(labels), s, weights=opt(w, jnp.asarray),
                      mask=opt(mask, jnp.asarray), reduction=reduction),
      logits)
  got = _value_and_grad_torch(
      lambda s: tloss(torch.from_numpy(labels), s,
                      weights=opt(w, torch.from_numpy),
                      mask=opt(mask, torch.from_numpy), reduction=reduction),
      logits)
  for g, wnt in zip(got, want):
    np.testing.assert_allclose(g, wnt, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('lambda_name', sorted(_LAMBDA_WEIGHTS))
@pytest.mark.parametrize('cls', _PAIRWISE)
def test_pairwise_loss_with_lambda_weight_matches_jax(cls, lambda_name):
  labels, logits, weights = _data(7)
  logits = logits / 4   # see compute_ranks on a row minimum of large size
  jlam, tlam = _LAMBDA_WEIGHTS[lambda_name]
  jloss = getattr(jax_losses, cls)(lambda_weight=jlam)
  tloss = getattr(losses, cls)(lambda_weight=tlam)
  want = _value_and_grad_jax(
      lambda s: jloss(jnp.asarray(labels), s, weights=jnp.asarray(weights)),
      logits)
  got = _value_and_grad_torch(
      lambda s: tloss(torch.from_numpy(labels), s,
                      weights=torch.from_numpy(weights)), logits)
  for g, wnt in zip(got, want):
    np.testing.assert_allclose(g, wnt, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('cls', _PAIRWISE)
def test_pairwise_per_list_and_unreduced_match_jax(cls):
  labels, logits, weights = _data(8)
  jlam, tlam = _LAMBDA_WEIGHTS['ndcg']
  jloss = getattr(jax_losses, cls)(lambda_weight=jlam)
  tloss = getattr(losses, cls)(lambda_weight=tlam)
  want = jloss.per_list(jnp.asarray(labels), jnp.asarray(logits),
                        weights=jnp.asarray(weights))
  got = tloss.per_list(torch.from_numpy(labels), torch.from_numpy(logits),
                       weights=torch.from_numpy(weights))
  for g, w in zip(got, want):
    assert g.shape == (B,)
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
  want = jloss.unreduced(jnp.asarray(labels), jnp.asarray(logits))
  got = tloss.unreduced(torch.from_numpy(labels),
                        torch.from_numpy(logits).requires_grad_())
  assert not got[1].requires_grad   # pair weights carry no gradient
  for g, w in zip(got, want):
    assert g.shape == (B, L, L)
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=RTOL,
                               atol=ATOL)
  np.testing.assert_allclose(
      tloss.normalize_weights(torch.from_numpy(labels),
                              torch.from_numpy(weights)).numpy(),
      np.asarray(jloss.normalize_weights(jnp.asarray(labels),
                                         jnp.asarray(weights))))


def test_pairwise_comparison_matches_jax():
  labels, logits, _ = _data(9)
  mask = labels >= 0
  want = jax_losses.pairwise_comparison(jnp.asarray(labels),
                                        jnp.asarray(logits),
                                        jnp.asarray(mask))
  got = losses.pairwise_comparison(torch.from_numpy(labels),
                                   torch.from_numpy(logits),
                                   torch.from_numpy(mask))
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize('reduction', ['mean', 'sum_by_nonzero_weights'])
@pytest.mark.parametrize('lambda_name', ['ndcg', 'ndcg_top3_smooth', 'ndcg_v2',
                                         'yeti'])
def test_softmax_dcg_lambda_branch_matches_jax(lambda_name, reduction):
  """Only a DCGLambdaWeight instance takes the branch; the others leave the
  labels as they are, in both packages."""
  labels, logits, weights = _data(10)
  logits = logits / 4
  jlam, tlam = _LAMBDA_WEIGHTS[lambda_name]
  jloss = jax_losses.SoftmaxLoss(lambda_weight=jlam)
  tloss = losses.SoftmaxLoss(lambda_weight=tlam)
  want = _value_and_grad_jax(
      lambda s: jloss(jnp.asarray(labels), s, weights=jnp.asarray(weights),
                      reduction=reduction), logits)
  got = _value_and_grad_torch(
      lambda s: tloss(torch.from_numpy(labels), s,
                      weights=torch.from_numpy(weights), reduction=reduction),
      logits)
  for g, wnt in zip(got, want):
    np.testing.assert_allclose(g, wnt, rtol=RTOL, atol=ATOL)
  takes_branch = isinstance(tlam, lw.DCGLambdaWeight)
  plain = losses.SoftmaxLoss()(torch.from_numpy(labels),
                               torch.from_numpy(logits),
                               weights=torch.from_numpy(weights),
                               reduction=reduction).item()
  assert (abs(got[0] - plain) > 1e-4) == takes_branch


@pytest.mark.parametrize('lambda_name', [None, 'label_diff', 'ndcg',
                                         'ndcg_v2', 'yeti'])
@pytest.mark.parametrize('cls', _PAIRWISE[:3])
def test_fused_forced_on_the_cpu_equals_the_plain_path(cls, lambda_name):
  labels, logits, weights = (torch.from_numpy(a) for a in _data(11))
  lam = _LAMBDA_WEIGHTS.get(lambda_name, (None, None))[1]
  loss = getattr(losses, cls)(lambda_weight=lam)

  def run(enabled, generator=None):
    cuda_pairwise.set_enabled(enabled)
    try:
      s = (logits / 4).requires_grad_()
      value = loss(labels, s, weights=weights, generator=generator)
      value.backward()
      return value.detach(), s.grad
    finally:
      cuda_pairwise.set_enabled(None)

  for g, w in zip(run(True), run(False)):
    torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
  # With one seed the shuffled ties are the same on both paths.
  gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
  for g, w in zip(run(True, gen()), run(False, gen())):
    torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)


def test_loss_fn_hands_its_generator_to_every_loss():
  labels, logits, _ = (torch.from_numpy(a) for a in _data(12))
  logits = torch.round(logits)   # tied logits: the shuffle matters
  fn = loss_registry.make_loss_fn(
      ['pairwise_logistic_loss', 'softmax_loss'],
      lambda_weight=lw.create_ndcg_lambda_weight())
  gen = lambda seed: torch.Generator().manual_seed(seed)  # noqa: E731
  a, again, b = (fn(labels, logits, generator=gen(s)) for s in (1, 1, 2))
  assert a.item() == again.item() != b.item()
  assert fn(labels, logits).item() == fn(labels, logits).item()


def test_factory_refuses_what_is_not_ported():
  assert (loss_registry.RankingLossKey.all_keys()
          == jax_registry.RankingLossKey.all_keys())
  assert loss_registry._LAMBDA_KEYS == jax_registry._LAMBDA_KEYS
  assert loss_registry.NO_LAMBDA == jax_registry.NO_LAMBDA
  # Every key is ported now: none refuses (tests/test_torch_loss_zoo.py
  # holds them to the JAX package).
  for key in ('yeti_logistic_loss', 'circle_loss', 'approx_ndcg_loss'):
    assert callable(loss_registry.make_loss_fn(key))
  for key, cls in (('pairwise_logistic_loss', losses.PairwiseLogisticLoss),
                   ('pairwise_hinge_loss', losses.PairwiseHingeLoss),
                   ('pairwise_soft_zero_one_loss',
                    losses.PairwiseSoftZeroOneLoss),
                   ('pairwise_mse_loss', losses.PairwiseMSELoss)):
    lam = lw.create_ndcg_lambda_weight()
    built = loss_registry.build_loss(key, lam)
    assert type(built) is cls and built.lambda_weight is lam
    assert built.name == key
    assert loss_registry.build_loss(
        key, loss_registry.NO_LAMBDA).lambda_weight is None
  lam = lw.create_ndcg_lambda_weight()
  assert loss_registry.build_loss('softmax_loss', lam).lambda_weight is lam
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
