"""The port's loss zoo == the JAX package's, on the CPU.

The 20 loss keys beyond softmax and the four pairwise ones go through
``build_loss``, ``make_loss_fn`` and ``make_loss_metric_fn`` of both packages
on the same numpy batch (B=6, L=8: an all-zero-label list, a padded list, an
all-padding list, item weights): the value under the four training
reductions and the gradient of the logits, ``per_list``, and the
loss-as-metric stream, within rtol 1e-5 and atol 1e-5 (float32 sums of up to
L^2 terms and log-softmaxes in another order; circle loss sums exp(64 x)).

The two packages draw random numbers from different generators (threefry,
torch), so no test compares two random streams. The Gumbel keys and
``CoupledRankDistilLoss`` run with both packages' ``sample_gumbel`` patched to
return the same numpy noise. ListMLE is compared exactly on labels without
ties; on tied labels its properties are checked: the same draws give the
same loss, and its value is the JAX loss of a label order that differs only
by a permutation within ties. The quirks that the port mirrors are pinned
each by a test.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ranking_tpu.ops import loss_registry as jax_registry
from ranking_tpu.ops import losses as jax_losses
from ranking_tpu.ops import sorting as jax_sorting
from ranking_tpu_torch.ops import loss_registry, losses, sorting
from ranking_tpu_torch.utils import list_ops

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

B, L, S = 6, 8, 8            # S: the Gumbel samples a list (the default)
RTOL, ATOL = 1e-5, 1e-5
REDUCTIONS = ['sum', 'mean', 'sum_over_batch_size', 'sum_by_nonzero_weights']

# key -> (constructor params, logits' trailing units or None, label kind)
KEYS = {
    'yeti_logistic_loss': ({}, None, 'graded'),
    'circle_loss': ({}, None, 'graded'),
    'calibrated_softmax_loss': ({'virtual_label': 1.0}, None, 'graded'),
    'poly_one_softmax_loss': ({'epsilon': 0.5}, None, 'graded'),
    'unique_softmax_loss': ({}, None, 'graded'),
    'sigmoid_cross_entropy_loss': ({}, None, 'binary'),
    'mean_squared_loss': ({}, None, 'graded'),
    'list_mle_loss': ({}, None, 'distinct'),
    'approx_ndcg_loss': ({}, None, 'graded'),
    'approx_mrr_loss': ({}, None, 'graded'),
    'gumbel_approx_ndcg_loss': ({}, None, 'graded'),
    'neural_sort_cross_entropy_loss': ({}, None, 'graded'),
    'gumbel_neural_sort_cross_entropy_loss': ({}, None, 'graded'),
    'neural_sort_ndcg_loss': ({}, None, 'graded'),
    'gumbel_neural_sort_ndcg_loss': ({}, None, 'graded'),
    'ordinal_loss': ({'ordinal_size': 4, 'use_fraction_label': True}, 4,
                     'fractional'),
    'multi_class_loss': ({'num_classes': 5, 'from_logits': True,
                          'label_smoothing': 0.1}, 5, 'graded'),
    'click_em_loss': ({'exam_loss_weight': 0.5}, 2, 'binary'),
    'mixture_em_loss': ({'alpha': 0.7}, 3, 'binary'),
    'coupled_rankdistil_loss': ({'topk': 5}, None, 'graded'),
}


def _data(kind='graded', units=None, seed=0):
  rng = np.random.RandomState(seed)
  if kind == 'distinct':
    labels = np.stack([rng.permutation(L) for _ in range(B)]).astype(
        np.float32) / 2
  elif kind == 'binary':
    labels = (rng.rand(B, L) < 0.4).astype(np.float32)
  elif kind == 'fractional':
    labels = np.round(rng.uniform(0, 4, (B, L)) * 4) / 4
  else:
    labels = rng.randint(0, 5, (B, L)).astype(np.float32)
  if kind != 'distinct':
    labels[1] = 0.0           # a list with no relevant document
  labels[2, 5:] = -1.0        # a padded list
  labels[3] = -1.0            # an all-padding list
  shape = (B, L) if units is None else (B, L, units)
  logits = (rng.randn(*shape) * 1.5).astype(np.float32)
  weights = rng.uniform(0.5, 2.0, (B, L)).astype(np.float32)
  return labels.astype(np.float32), logits, weights


def _inputs(key, seed=0):
  params, units, kind = KEYS[key]
  labels, logits, weights = _data(kind, units, seed)
  if key == 'circle_loss':   # similarity scores, most inside [0, 1]
    logits = np.random.RandomState(seed).uniform(
        -0.2, 1.2, logits.shape).astype(np.float32)
  return params, labels, logits, weights


def _noise(shape):
  """Gumbel noise of a shape, the same whenever that shape is asked for."""
  shape = tuple(shape)
  if shape not in _NOISE:
    _NOISE[shape] = np.random.RandomState(
        7 + sum(shape) * 31 + len(shape)).gumbel(size=shape).astype(
            np.float32)
  return _NOISE[shape]


_NOISE = {}


@pytest.fixture(autouse=True)
def same_noise(monkeypatch):
  """Both packages' ``sample_gumbel`` return the same numpy noise; returns
  the list of shapes the port asked for."""
  calls = []

  def port(generator, shape, eps=1e-20, device=None, seed=17):
    calls.append(tuple(shape))
    return torch.from_numpy(_noise(shape)).to(device or 'cpu')

  monkeypatch.setattr(jax_sorting, 'sample_gumbel',
                      lambda key, shape, eps=1e-20: jnp.asarray(_noise(shape)))
  monkeypatch.setattr(sorting, 'sample_gumbel', port)
  return calls


@functools.lru_cache(maxsize=None)
def _jax_reference(key):
  """The JAX package's numbers for a key, in one jitted call (one compile
  for the key, not one for each primitive): value and logit gradient under
  each reduction of ``make_loss_fn`` on ``_inputs(key)``, and ``per_list``
  and the loss-as-metric stream on ``_inputs(key, seed=1)``."""
  params, labels, logits, weights = _inputs(key)
  _, labels1, logits1, weights1 = _inputs(key, seed=1)

  def run(s, s1):
    out = {}
    for reduction in REDUCTIONS:
      fn = jax_registry.make_loss_fn(key, weights_feature_name='w',
                                     reduction=reduction, params=params)
      out[reduction] = jax.value_and_grad(
          lambda x: fn(labels, x, features={'w': weights}))(s)
    out['per_list'] = jax_registry.build_loss(key, **params).per_list(
        labels1, s1, weights=weights1)
    out['metric'] = jax_registry.make_loss_metric_fn(
        key, weights_feature_name='w', **params)(labels1, s1,
                                                 features={'w': weights1})
    return out

  return jax.tree.map(np.asarray, jax.jit(run)(logits, logits1))


def _value_and_grad_jax(fn, logits):
  value, grad = jax.jit(jax.value_and_grad(fn))(jnp.asarray(logits))
  return np.asarray(value), np.asarray(grad)


def _value_and_grad_torch(fn, logits):
  t = torch.from_numpy(logits.copy()).requires_grad_()
  value = fn(t)
  value.backward()
  return value.detach().numpy(), t.grad.numpy()


def _close(got, want, **kw):
  for g, w in zip(got, want):
    g = g.detach().numpy() if torch.is_tensor(g) else np.asarray(g)
    w = np.asarray(w)
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=kw.get('rtol', RTOL),
                               atol=kw.get('atol', ATOL))


@pytest.mark.parametrize('reduction', REDUCTIONS)
@pytest.mark.parametrize('key', sorted(KEYS))
def test_loss_fn_value_and_gradient_match_jax(key, reduction):
  params, labels, logits, weights = _inputs(key)
  tfn = loss_registry.make_loss_fn(key, weights_feature_name='w',
                                   reduction=reduction, params=params)
  got = _value_and_grad_torch(
      lambda s: tfn(torch.from_numpy(labels), s,
                    features={'w': torch.from_numpy(weights)}), logits)
  assert np.isfinite(got[0]) and np.all(np.isfinite(got[1]))
  _close(got, _jax_reference(key)[reduction])


@pytest.mark.parametrize('key', sorted(KEYS))
def test_per_list_and_loss_metric_match_jax(key):
  params, labels, logits, weights = _inputs(key, seed=1)
  tloss = loss_registry.build_loss(key, **params)
  assert type(tloss).__name__ == type(
      jax_registry.build_loss(key, **params)).__name__
  assert tloss.name == key
  got = tloss.per_list(torch.from_numpy(labels), torch.from_numpy(logits),
                       weights=torch.from_numpy(weights))
  _close(got, _jax_reference(key)['per_list'])
  got = loss_registry.make_loss_metric_fn(
      key, weights_feature_name='w', **params)(
          torch.from_numpy(labels), torch.from_numpy(logits),
          features={'w': torch.from_numpy(weights)})
  _close(got, _jax_reference(key)['metric'])


def test_calibrated_softmax_metric_scores_the_augmented_objective():
  _, labels, logits, _ = _inputs('calibrated_softmax_loss', seed=2)
  fn = loss_registry.make_loss_metric_fn('calibrated_softmax_loss',
                                         virtual_label=1.0)
  values, weights = fn(torch.from_numpy(labels), torch.from_numpy(logits))
  plain, _ = losses.SoftmaxLoss().per_list(torch.from_numpy(labels),
                                           torch.from_numpy(logits))
  assert values.shape == (B,) and not torch.allclose(values, plain)
  total = (values * weights).sum() / weights.sum()
  value = loss_registry.build_loss('calibrated_softmax_loss',
                                   virtual_label=1.0)(
      torch.from_numpy(labels), torch.from_numpy(logits), reduction='mean')
  torch.testing.assert_close(total, value, rtol=RTOL, atol=ATOL)
  with pytest.raises(ValueError, match='non-negative'):
    losses.CalibratedSoftmaxLoss(virtual_label=-1.0)


@pytest.mark.parametrize('scale_invariant', [None, True, False])
@pytest.mark.parametrize('key', ['approx_ndcg_loss', 'approx_mrr_loss',
                                 'gumbel_approx_ndcg_loss'])
def test_scale_invariant_default_and_reference_recipe(key, scale_invariant):
  params = ({} if scale_invariant is None
            else {'scale_invariant': scale_invariant})
  built = loss_registry.build_loss(key, **params)
  si = scale_invariant is not False
  assert built.scale_invariant is si
  assert built.temperature == (
      loss_registry.SCALE_INVARIANT_TEMPERATURE if si else 0.1) == (
          jax_registry.build_loss(key, **params).temperature)
  assert loss_registry.SCALE_INVARIANT_TEMPERATURE == 0.25
  _, labels, logits, weights = _inputs(key, seed=3)
  want = _value_and_grad_jax(
      lambda s: jax_registry.make_loss_fn(key, params=params)(
          jnp.asarray(labels), s), logits)
  got = _value_and_grad_torch(
      lambda s: loss_registry.make_loss_fn(key, params=params)(
          torch.from_numpy(labels), s), logits)
  _close(got, want)
  # The SI recipe does not see a scale of the logits; the reference's does
  # (the Gumbel key samples before it standardizes: the noise is not
  # scaled).
  if not key.startswith('gumbel'):
    base = loss_registry.make_loss_fn(key, params=params)
    t = torch.from_numpy(logits)
    scaled = [base(torch.from_numpy(labels), t * c).item() for c in (1, 7)]
    assert (abs(scaled[0] - scaled[1]) < 1e-5) == si


def test_registry_builds_every_key_with_the_jax_defaults():
  assert (loss_registry.RankingLossKey.all_keys()
          == jax_registry.RankingLossKey.all_keys())
  assert len(loss_registry.RankingLossKey.all_keys()) == 25
  assert loss_registry._GUMBEL_KEYS == jax_registry._GUMBEL_KEYS
  assert loss_registry._SCALE_INVARIANT_DEFAULT_KEYS == (
      jax_registry._SCALE_INVARIANT_DEFAULT_KEYS)
  for key in loss_registry.RankingLossKey.all_keys():
    built = loss_registry.build_loss(key)
    assert type(built).__name__ == type(jax_registry.build_loss(key)).__name__
  yeti = loss_registry.build_loss('yeti_logistic_loss')
  assert type(yeti.lambda_weight).__name__ == 'YetiDCGLambdaWeight'
  assert loss_registry.build_loss(
      'yeti_logistic_loss', loss_registry.NO_LAMBDA).lambda_weight is None
  with pytest.raises(ValueError, match='Unknown gumbel_params'):
    loss_registry.make_loss_fn('gumbel_approx_ndcg_loss',
                               gumbel_params={'size': 3})


@pytest.mark.parametrize('config', [
    dict(loss_keys=['gumbel_approx_ndcg_loss', 'yeti_logistic_loss',
                    'softmax_loss'], loss_weights=[0.5, 2.0, 1.0]),
    dict(loss_keys='gumbel_neural_sort_ndcg_loss',
         gumbel_params={'sample_size': 4, 'temperature': 0.5}),
])
def test_one_gumbel_sample_is_shared_by_the_keys_of_a_call(config,
                                                           same_noise):
  _, labels, logits, weights = _inputs('gumbel_approx_ndcg_loss', seed=4)
  jfn = jax_registry.make_loss_fn(weights_feature_name='w', **config)
  tfn = loss_registry.make_loss_fn(weights_feature_name='w', **config)
  want = _value_and_grad_jax(
      lambda s: jfn(jnp.asarray(labels), s,
                    features={'w': jnp.asarray(weights)}), logits)
  got = _value_and_grad_torch(
      lambda s: tfn(torch.from_numpy(labels), s,
                    features={'w': torch.from_numpy(weights)}), logits)
  _close(got, want)
  size = config.get('gumbel_params', {}).get('sample_size', S)
  assert same_noise == [(B, size, L)]


def test_generator_and_kept_draws(monkeypatch):
  """Without the patch: a generator's draws differ by seed and repeat with
  it; without a generator every call takes the same kept draws."""
  monkeypatch.undo()
  labels, logits, _ = (torch.from_numpy(a) for a in _data(seed=5))
  fn = loss_registry.make_loss_fn(['gumbel_approx_ndcg_loss',
                                   'coupled_rankdistil_loss'])
  gen = lambda seed: torch.Generator().manual_seed(seed)  # noqa: E731
  a, again, b = (fn(labels, logits, generator=gen(s)).item()
                 for s in (1, 1, 2))
  assert a == again != b
  assert fn(labels, logits).item() == fn(labels, logits).item()
  first = sorting.fixed_draws(17, [(B, S, L)], 'cpu')[0]
  assert first is sorting.fixed_draws(17, [(B, S, L)], 'cpu')[0]
  torch.testing.assert_close(
      first, torch.rand((B, S, L), generator=gen(17)), rtol=0, atol=0)
  noise = sorting.sample_gumbel(None, (B, S, L))
  torch.testing.assert_close(noise, -torch.log(-torch.log(first + 1e-20)
                                                + 1e-20))


@pytest.mark.parametrize('cls,ragged_weights', [
    ('ApproxNDCGLoss', True), ('PairwiseLogisticLoss', True),
    ('SoftmaxLoss', True), ('CalibratedSoftmaxLoss', True),
    ('SoftmaxLoss', False), ('SigmoidCrossEntropyLoss', False)])
def test_ragged_inputs_match_jax(cls, ragged_weights):
  labels = [[1.0, 0.0, 3.0], [2.0, 1.0], [0.0, 1.0, 2.0, 4.0]]
  logits = [[0.5, -1.0, 2.0], [0.1, 0.3], [1.0, -0.5, 0.2, 2.5]]
  weights = ([[1.0, 2.0, 0.5], [1.5, 1.0], [1.0, 1.0, 2.0, 0.5]]
             if ragged_weights else None)
  want = getattr(jax_losses, cls)()(labels, logits, weights=weights,
                                    ragged=True)
  got = getattr(losses, cls)()(labels, logits, weights=weights, ragged=True)
  np.testing.assert_allclose(got.item(), float(want), rtol=RTOL, atol=ATOL)
  dense = list_ops.ragged_to_dense(labels, logits, weights)
  again = getattr(losses, cls)()(dense[0], dense[1], weights=dense[2],
                                 mask=dense[3])
  assert again.item() == got.item()


def test_approx_ranks_ndcg_and_neural_sort_match_jax():
  labels, logits, _ = _data(seed=6)
  mask = labels >= 0
  mask[4, [1, 4]] = False            # masked items inside a list
  _close([sorting.approx_ranks(torch.from_numpy(logits))],
         [jax_sorting.approx_ranks(jnp.asarray(logits))])
  got = sorting.neural_sort(torch.from_numpy(logits),
                            mask=torch.from_numpy(mask), temperature=0.5)
  want = jax_sorting.neural_sort(jnp.asarray(logits), mask=jnp.asarray(mask),
                                 temperature=0.5)
  _close([got], [want], atol=1e-6)
  # Masked items are pinned to the trailing rows, the valid rows keep their
  # order, and an invalid rank spreads evenly over the invalid items.
  n = int(mask[4].sum())
  torch.testing.assert_close(got[4, n:, ~torch.from_numpy(mask[4])],
                             torch.full((L - n, L - n), 1 / (L - n)))
  torch.testing.assert_close(got[4, :n].sum(-1), torch.ones(n))
  clean = np.where(labels >= 0, labels, 0.0).astype(np.float32)
  for kw in ({'perm_mat': got}, {'ranks': sorting.approx_ranks(
      torch.from_numpy(logits))}, {}):
    jkw = {k: jnp.asarray(v.numpy()) for k, v in kw.items()}
    _close([sorting.ndcg(torch.from_numpy(clean), **kw)],
           [jax_sorting.ndcg(jnp.asarray(clean), **jkw)])
  with pytest.raises(ValueError, match='at most one'):
    sorting.ndcg(torch.from_numpy(clean), ranks=got[:, 0], perm_mat=got)


@pytest.mark.parametrize('labels_rank,weights_rank', [(2, 2), (2, 1),
                                                      (3, None)])
def test_gumbel_sample_lists_and_neural_sort_match_jax(labels_rank,
                                                       weights_rank):
  labels, logits, weights = _data(seed=7)
  if labels_rank == 3:              # [B, L, subtopics]
    labels = np.stack([labels, np.where(labels >= 0, 1.0, -1.0)], axis=-1)
  if weights_rank == 1:
    weights = weights[:, 0]
  w = None if weights_rank is None else weights
  want = jax_sorting.gumbel_sample_lists(
      jnp.asarray(labels), jnp.asarray(logits), jax.random.PRNGKey(0),
      weights=w, sample_size=3, temperature=0.7)
  got = sorting.gumbel_sample_lists(
      torch.from_numpy(labels), torch.from_numpy(logits), None,
      weights=None if w is None else torch.from_numpy(w), sample_size=3,
      temperature=0.7)
  assert (got[2] is None) == (want[2] is None)
  _close([t for t in got if t is not None], [t for t in want if t is not None])
  assert got[0].shape[0] == B * 3
  _close([sorting.gumbel_neural_sort(torch.from_numpy(logits), None, 3, 0.5)],
         [jax_sorting.gumbel_neural_sort(jnp.asarray(logits),
                                         jax.random.PRNGKey(0), 3, 0.5)],
         atol=1e-6)


def _plackett_luce_nll(logits_in_order):
  s = np.asarray(logits_in_order, np.float64)
  return sum(np.log(np.sum(np.exp(s[i:]))) - s[i] for i in range(len(s)))


def test_list_mle_on_tied_labels_is_a_permutation_within_ties():
  labels, logits, _ = _data('graded', seed=8)
  t_labels, t_logits = torch.from_numpy(labels), torch.from_numpy(logits)
  loss = losses.ListMLELoss()
  value = loss.unreduced(t_labels, t_logits)[0]
  assert torch.equal(value, loss.unreduced(t_labels, t_logits)[0])
  gen = lambda seed: torch.Generator().manual_seed(seed)  # noqa: E731
  assert torch.equal(loss.unreduced(t_labels, t_logits, generator=gen(3))[0],
                     loss.unreduced(t_labels, t_logits, generator=gen(3))[0])
  # The order the kept draws chose, from the same draws.
  mask = t_labels >= 0
  clean = torch.where(mask, t_labels, 0.0)
  scores = torch.where(mask, clean, clean.amin(1, keepdim=True) - 1e-6)
  draws = sorting.fixed_draws(37, [(B, L)], 'cpu')[0]
  order, = list_ops.sort_by_scores(
      scores, [torch.arange(L).expand(B, L)], tie_draws=draws)
  sorted_labels = torch.gather(clean, 1, order)
  assert torch.all(sorted_labels[:, :-1] >= sorted_labels[:, 1:])
  # Labels without ties in that order: the JAX loss equals the port's.
  distinct = np.full((B, L), -1.0, np.float32)
  for b in range(B):
    for k, i in enumerate(order[b].tolist()):
      if labels[b, i] >= 0:
        distinct[b, i] = L - k
  want = jax_losses.ListMLELoss().unreduced(jnp.asarray(distinct),
                                            jnp.asarray(logits))[0]
  np.testing.assert_allclose(value.numpy(), np.asarray(want), rtol=RTOL,
                             atol=ATOL)
  # Another tie order changes the value: the shuffle matters.
  values = {round(loss.unreduced(t_labels, t_logits, generator=gen(s))[0]
                  .sum().item(), 4) for s in range(6)}
  assert len(values) > 1


def test_list_mle_fills_invalid_items_with_the_row_minimum_less_1e_6():
  """With a valid label of magnitude 3e8, the fill (row min - 1e-6) equals
  the row minimum in float32: the invalid item ties with it, and the tie
  shuffle may put it first."""
  labels = torch.tensor([[-3e8, 7.0, 2.0]])
  mask = torch.tensor([[True, False, True]])
  logits = torch.tensor([[0.3, 1.0, -0.4]])
  loss = losses.ListMLELoss()
  seen = set()
  for seed in range(12):
    value = loss.unreduced(labels, logits, mask=mask,
                           generator=torch.Generator().manual_seed(seed))[0]
    seen.add(round(value.item(), 4))
  log_eps = losses.LOG_EPSILON
  want = {round(_plackett_luce_nll([-0.4, 0.3, log_eps]), 4),
          round(_plackett_luce_nll([-0.4, log_eps, 0.3]), 4)}
  assert seen == want


def test_unique_softmax_fills_with_the_batch_minimum():
  x = torch.tensor([[[1.0, 2.0]], [[-50.0, 3.0]]])
  assert losses._unique_softmax_fill(x).item() == pytest.approx(-50.001)
  labels, logits, _ = _data(seed=9)
  logits[0] *= 40                    # rows with far apart minima
  want = jax_losses.UniqueSoftmaxLoss().unreduced(jnp.asarray(labels),
                                                  jnp.asarray(logits))
  got = losses.UniqueSoftmaxLoss().unreduced(torch.from_numpy(labels),
                                             torch.from_numpy(logits))
  _close(got, want, atol=1e-4)


def test_coupled_rank_distil_denominator_adds_i_eps():
  labels = np.array([[2.0, 0.0, 1.0, -1.0, -1.0]], np.float32)
  logits = np.array([[0.5, -0.2, 0.1, 3.0, 3.0]], np.float32)
  loss = losses.CoupledRankDistilLoss(sample_size=2)
  got = loss.unreduced(torch.from_numpy(labels), torch.from_numpy(logits))[0]
  want = jax_losses.CoupledRankDistilLoss(sample_size=2).unreduced(
      jnp.asarray(labels), jnp.asarray(logits))[0]
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
  # By hand, in float64 over the patched noise: the masked tail's student
  # scores are log(eps), and the i-th denominator adds i * eps.
  noise = sorting.sample_gumbel(None, (1, 2, 5)).numpy()[0].astype(np.float64)
  teacher = np.where(labels[0] >= 0, labels[0], np.log(1e-10))
  student = np.where(labels[0] >= 0, logits[0], np.log(1e-10))
  nlls = []
  for sample in noise:
    p = np.exp(teacher + sample - np.max(teacher + sample))
    order = np.argsort(-np.log(p / p.sum() + 1e-10), kind='stable')
    s = student[order]
    nlls.append(-sum(s[i] - np.log(np.sum(np.exp(s[i:])) + i * 1e-10)
                     for i in range(5)))
  np.testing.assert_allclose(got.item(), np.mean(nlls), rtol=1e-5)


def test_ordinal_and_multi_class_refuse_logits_of_the_wrong_shape():
  labels = torch.zeros(2, 3)
  with pytest.raises(ValueError, match='Ordinal loss expects logits'):
    losses.OrdinalLoss(ordinal_size=3)(labels, torch.zeros(2, 3))
  with pytest.raises(ValueError, match='Ordinal loss expects logits'):
    losses.OrdinalLoss(ordinal_size=3)(labels, torch.zeros(2, 3, 2))
  with pytest.raises(ValueError, match='Multi-class loss expects logits'):
    losses.MultiClassLoss(num_classes=4)(labels, torch.zeros(2, 3, 3))
  with pytest.raises(ValueError, match='Multi-class loss expects logits'):
    losses.MultiClassLoss(num_classes=4)(labels, torch.zeros(2, 3))


def test_multi_class_on_probabilities_matches_jax():
  """``from_logits=False``: non-negative scores normalized per item, and a
  label outside [0, C) a row of zeros (jax.nn.one_hot)."""
  labels, _, weights = _data(seed=10)
  labels[0, :2] = 7.0
  probs = np.random.RandomState(10).uniform(0, 1, (B, L, 5)).astype(
      np.float32)
  jloss = jax_losses.MultiClassLoss(num_classes=5, label_smoothing=0.2)
  tloss = losses.MultiClassLoss(num_classes=5, label_smoothing=0.2)
  want = _value_and_grad_jax(
      lambda s: jloss(jnp.asarray(labels), s, weights=jnp.asarray(weights)),
      probs)
  got = _value_and_grad_torch(
      lambda s: tloss(torch.from_numpy(labels), s,
                      weights=torch.from_numpy(weights)), probs)
  _close(got, want)
