"""The port's fused pairwise sums and their dispatcher == the JAX package's.

On the CPU ``fused_pairwise_sums`` computes its plain PyTorch version (the
CUDA kernels are held to that version on the card). Here it is compared:

* with the JAX package's Pallas kernel, run in interpret mode as its own
  tests run it, forward and gradient, for every loss type x lambda mode and
  every discount kind, at B=5, L=70 (the Pallas kernel's 64-row tile is
  crossed and its batch tile is ragged);
* through ``_PairwiseLoss.__call__`` with the fused path forced on, with the
  JAX package's jnp path (its kernel switched off), under every reduction.

Inputs come from numpy with a seed. Sums and gradients agree within 1e-5 of
the output's largest value (float32 sums of up to L^2 terms in another
order); the count of non-zero pair weights agrees exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ranking_tpu.ops import lambda_weights as jax_lw
from ranking_tpu.ops import losses as jax_losses
from ranking_tpu.ops import pallas as pallas_ops
from ranking_tpu.ops.pallas import pairwise as pk
from ranking_tpu.utils import fns as jax_fns
from ranking_tpu_torch.ops import lambda_weights as lw
from ranking_tpu_torch.ops import losses
from ranking_tpu_torch.ops.cuda import pairwise as tp
from ranking_tpu_torch.utils import fns

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

B, L = 5, 70
TOL = 1e-5


@pytest.fixture
def jax_kernel():
  pk._INTERPRET = True
  pallas_ops.set_enabled(True)
  yield
  pk._INTERPRET = False
  pallas_ops.set_enabled(None)


@pytest.fixture
def fused_on_cpu():
  tp.set_enabled(True)
  yield
  tp.set_enabled(None)


def _data(seed=0, b=B, l=L, ties=True):
  rng = np.random.RandomState(seed)
  labels = rng.randint(0, 5, (b, l)).astype(np.float32)
  labels[:, -5:] = np.where(rng.rand(b, 5) < 0.6, -1.0, labels[:, -5:])
  labels[1] = np.where(labels[1] >= 0, 2.0, -1.0)   # no preference pair
  logits = (rng.randn(b, l) * 2).astype(np.float32)
  if ties:
    logits[2, :8] = 0.5                             # tied logits
  weights = (rng.rand(b, l) + 0.1).astype(np.float32)
  return labels, logits, weights


def _kernel_inputs(seed):
  labels, logits, weights = _data(seed)
  rng = np.random.RandomState(seed + 100)
  valid = labels >= 0
  clean = np.where(valid, labels, 0.0).astype(np.float32)
  return dict(
      labels=labels, logits=logits, mask=valid.astype(np.float32),
      norm_w=np.where(valid, weights, 0.0).astype(np.float32),
      gain=(2.0 ** clean - 1.0).astype(np.float32),
      ranks=np.stack([rng.permutation(L) + 1.0 for _ in range(B)]).astype(
          np.float32),
      scale=rng.uniform(0.5, 3.0, (B,)).astype(np.float32),
      ct=rng.randn(B, 3).astype(np.float32))


def _assert_share(got, want, name):
  """|got - want| within TOL of want's largest value."""
  scale = max(np.abs(want).max(), 1e-30)
  err = np.abs(got - want).max()
  assert err <= TOL * scale, f'{name}: off by {err} (largest value {scale})'


_DCG = (tp.LAMBDA_DCG_V2, tp.LAMBDA_DCG_V1, tp.LAMBDA_DCG_V2_NEIGHBOR)
_CASES = [(loss, mode, tp.DISCOUNT_LOG1P_INVERSE)
          for loss in (tp.LOSS_LOGISTIC, tp.LOSS_HINGE, tp.LOSS_SOFT_ZERO_ONE)
          for mode in (tp.LAMBDA_NONE, tp.LAMBDA_LABELDIFF) + _DCG]
# The other two discount kinds: the discount is one function under every
# mode, so each mode meets one of them (a Pallas case costs most of a second
# of tracing in interpret mode).
_CASES += [(tp.LOSS_LOGISTIC, tp.LAMBDA_DCG_V2, tp.DISCOUNT_LOG2_INVERSE),
           (tp.LOSS_LOGISTIC, tp.LAMBDA_DCG_V1, tp.DISCOUNT_INVERSE),
           (tp.LOSS_LOGISTIC, tp.LAMBDA_DCG_V2_NEIGHBOR,
            tp.DISCOUNT_LOG2_INVERSE)]


@pytest.mark.parametrize('loss_type,lambda_mode,discount_kind', _CASES)
def test_sums_and_gradient_match_the_pallas_kernel(jax_kernel, loss_type,
                                                   lambda_mode, discount_kind):
  d = _kernel_inputs(seed=loss_type * 10 + lambda_mode)
  # topn inside the list for the first discount kind, unbounded otherwise.
  topn = 10.0 if discount_kind == tp.DISCOUNT_LOG1P_INVERSE else 1e9
  smooth = 0.25 if lambda_mode == tp.LAMBDA_DCG_V1 else 0.0
  j = {k: jnp.asarray(v) for k, v in d.items()}

  def jax_sums(logits):
    return pk.fused_pairwise_sums(
        j['labels'], logits, j['mask'], j['norm_w'], loss_type, lambda_mode,
        j['gain'], j['ranks'], j['scale'], discount_kind, topn, smooth)

  want, vjp = jax.vjp(jax_sums, j['logits'])   # one trace for both
  want, want_grad = np.asarray(want), np.asarray(vjp(j['ct'])[0])

  t = {k: torch.from_numpy(v) for k, v in d.items()}
  logits = t['logits'].clone().requires_grad_()
  got = tp.fused_pairwise_sums(
      t['labels'], logits, t['mask'], t['norm_w'], loss_type, lambda_mode,
      t['gain'], t['ranks'], t['scale'], discount_kind, topn, smooth)
  (got * t['ct']).sum().backward()
  got = got.detach().numpy()
  assert got.shape == (B, 3)
  np.testing.assert_array_equal(got[:, 2], want[:, 2])   # the count: exact
  assert got[1].tolist() == [0.0, 0.0, 0.0]              # a list with no pair
  _assert_share(got[:, 0], want[:, 0], 'loss_sum')
  _assert_share(got[:, 1], want[:, 1], 'weight_sum')
  _assert_share(logits.grad.numpy(), want_grad, 'dlogits')
  assert torch.all(logits.grad[1] == 0)


def test_gradient_reference_equals_autograd_through_the_slab():
  """``pairwise_sums_grad_reference`` is the analytic gradient of
  ``pairwise_sums_reference``'s first column."""
  d = {k: torch.from_numpy(v) for k, v in _kernel_inputs(7).items()}
  for loss_type in (tp.LOSS_LOGISTIC, tp.LOSS_SOFT_ZERO_ONE):
    static = (loss_type, tp.LAMBDA_DCG_V1, tp.DISCOUNT_LOG2_INVERSE, 7.0, 0.5)
    ops = [d[k] for k in ('labels', 'logits', 'mask', 'norm_w', 'gain',
                          'ranks', 'scale')]
    got = tp.pairwise_sums_grad_reference(*ops, *static, d['ct'])
    logits = d['logits'].clone().requires_grad_()
    pw, diff = tp._slab(ops[0], logits, *ops[2:], *static[1:])
    value = losses.PairwiseLogisticLoss()._pairwise_loss(diff) if (
        loss_type == tp.LOSS_LOGISTIC) else torch.sigmoid(-diff)
    ((value * pw).sum(dim=(1, 2)) * d['ct'][:, 0]).sum().backward()
    _assert_share(got.numpy(), logits.grad.numpy(), 'dlogits')


def _loss_pairs():
  """(JAX loss, port loss) over the configurations the dispatcher takes."""
  both = lambda make: (  # noqa: E731
      make(jax_losses, jax_lw, jax_fns), make(losses, lw, fns))
  return {
      'logistic': both(lambda m, w, f: m.PairwiseLogisticLoss()),
      'hinge': both(lambda m, w, f: m.PairwiseHingeLoss()),
      'soft_zero_one': both(lambda m, w, f: m.PairwiseSoftZeroOneLoss()),
      'logistic_temperature': both(
          lambda m, w, f: m.PairwiseLogisticLoss(temperature=0.5)),
      'hinge_label_diff': both(lambda m, w, f: m.PairwiseHingeLoss(
          lambda_weight=w.LabelDiffLambdaWeight())),
      'logistic_ndcg': both(lambda m, w, f: m.PairwiseLogisticLoss(
          lambda_weight=w.create_ndcg_lambda_weight())),
      'logistic_ndcg_top5_smooth': both(lambda m, w, f: m.PairwiseLogisticLoss(
          lambda_weight=w.create_ndcg_lambda_weight(topn=5,
                                                    smooth_fraction=0.4))),
      'hinge_v1_log2_smooth1': both(lambda m, w, f: m.PairwiseHingeLoss(
          lambda_weight=w.DCGLambdaWeight(
              topn=5, smooth_fraction=1.0, gain_fn=f.pow_minus_1,
              rank_discount_fn=f.log2_inverse))),
      'soft_ndcg_v2': both(lambda m, w, f: m.PairwiseSoftZeroOneLoss(
          lambda_weight=w.create_ndcg_lambda_weight_v2())),
      'hinge_v2_top5': both(lambda m, w, f: m.PairwiseHingeLoss(
          lambda_weight=w.DCGLambdaWeightV2(
              topn=5, normalized=True, gain_fn=f.pow_minus_1,
              rank_discount_fn=f.log2_inverse))),
      'logistic_v2_inverse': both(lambda m, w, f: m.PairwiseLogisticLoss(
          lambda_weight=w.DCGLambdaWeightV2(
              topn=3, gain_fn=f.pow_minus_1, rank_discount_fn=f.inverse))),
      'logistic_yeti': both(lambda m, w, f: m.PairwiseLogisticLoss(
          lambda_weight=w.create_yeti_dcg_lambda_weight())),
      'logistic_yeti_top4': both(lambda m, w, f: m.PairwiseLogisticLoss(
          lambda_weight=w.create_yeti_dcg_lambda_weight(topn=4))),
  }


def _count_fused_calls(monkeypatch):
  calls = []
  orig = tp.fused_pairwise_sums
  monkeypatch.setattr(tp, 'fused_pairwise_sums',
                      lambda *a, **k: calls.append(1) or orig(*a, **k))
  return calls


# Every loss under the default reduction; three of them under the others.
_LOSS_CASES = [(name, 'sum_by_nonzero_weights')
               for name in sorted(_loss_pairs())]
_LOSS_CASES += [(name, reduction)
                for name in ('hinge_label_diff', 'logistic_ndcg',
                             'soft_zero_one')
                for reduction in ('sum', 'mean', 'sum_over_batch_size')]


@pytest.mark.parametrize('name,reduction', _LOSS_CASES)
def test_fused_loss_matches_the_jnp_path(fused_on_cpu, monkeypatch, name,
                                         reduction):
  jloss, tloss = _loss_pairs()[name]
  # No tied logits here (see the test of tied logits below), and small
  # ones (see compute_ranks on the row minimum).
  labels, logits, weights = _data(seed=3, b=4, l=13, ties=False)
  logits = logits / 4
  pallas_ops.set_enabled(False)
  try:
    want, want_grad = jax.value_and_grad(
        lambda s: jloss(jnp.asarray(labels), s, weights=jnp.asarray(weights),
                        reduction=reduction))(jnp.asarray(logits))
  finally:
    pallas_ops.set_enabled(None)
  calls = _count_fused_calls(monkeypatch)
  s = torch.from_numpy(logits.copy()).requires_grad_()
  got = tloss(torch.from_numpy(labels), s, weights=torch.from_numpy(weights),
              reduction=reduction)
  got.backward()
  assert calls == [1]   # else this compares the plain path with itself
  np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6)
  _assert_share(s.grad.numpy(), np.asarray(want_grad), 'dlogits')


def test_dispatcher_declines_by_configuration(fused_on_cpu, monkeypatch):
  labels, logits, weights = (torch.from_numpy(a) for a in _data(4, 3, 9))
  calls = _count_fused_calls(monkeypatch)
  ask = lambda loss, **kw: tp.maybe_fused_pairwise(  # noqa: E731
      loss, kw.get('labels', labels), kw.get('logits', logits),
      kw.get('weights'), kw.get('mask'), kw.get('reduction', 'mean'))
  ndcg = losses.PairwiseLogisticLoss(
      lambda_weight=lw.create_ndcg_lambda_weight())
  none_cases = {
      'mse': ask(losses.PairwiseMSELoss()),
      'reduction none': ask(losses.PairwiseHingeLoss(), reduction='none'),
      '3-d labels': ask(losses.PairwiseHingeLoss(), labels=labels[..., None],
                        logits=logits[..., None]),
      'dcg with an explicit mask': ask(ndcg, mask=labels >= 0),
      'custom discount': ask(losses.PairwiseLogisticLoss(
          lambda_weight=lw.DCGLambdaWeight(
              rank_discount_fn=lambda r: 1.0 / (r + 1.0)))),
      'unknown lambda weight': ask(losses.PairwiseLogisticLoss(
          lambda_weight=lw.PrecisionLambdaWeight())),
      'a subclass of a known loss': ask(
          type('Mine', (losses.PairwiseHingeLoss,), {})()),
  }
  assert {k for k, v in none_cases.items() if v is not None} == set()
  assert calls == []
  # What it does take: an explicit mask without a DCG mode, item weights.
  for loss in (losses.PairwiseHingeLoss(),
               losses.PairwiseSoftZeroOneLoss(
                   lambda_weight=lw.LabelDiffLambdaWeight())):
    mask = labels >= 1
    got = ask(loss, mask=mask, weights=weights)
    tp.set_enabled(False)
    want = loss(labels, logits, weights=weights, mask=mask, reduction='mean')
    tp.set_enabled(True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
  assert calls == [1, 1]
  # Switched off, or on the CPU by default, it declines everything.
  for value in (False, None):
    tp.set_enabled(value)
    assert ask(losses.PairwiseHingeLoss()) is None
  assert tp.enabled(logits) is False


def test_hinge_gradient_at_the_boundary_matches_autograd(fused_on_cpu):
  """d == 1 exactly: jnp.maximum and torch.maximum split the tie, so the
  plain loss, the fused sums and the JAX package all give -0.5."""
  labels = np.array([[1.0, 0.0, 0.0]], np.float32)
  logits = np.array([[1.0, 0.0, -3.0]], np.float32)   # pair (0, 1): d == 1

  def port(enabled):
    tp.set_enabled(enabled)
    s = torch.from_numpy(logits.copy()).requires_grad_()
    losses.PairwiseHingeLoss()(torch.from_numpy(labels), s,
                               reduction='sum').backward()
    return s.grad.numpy()

  pallas_ops.set_enabled(False)
  try:
    want = np.asarray(jax.grad(
        lambda s: jax_losses.PairwiseHingeLoss()(
            jnp.asarray(labels), s, reduction='sum'))(jnp.asarray(logits)))
  finally:
    pallas_ops.set_enabled(None)
  np.testing.assert_array_equal(want, [[-0.5, 0.5, 0.0]])
  np.testing.assert_array_equal(port(False), want)
  np.testing.assert_array_equal(port(True), want)


def test_logistic_gradient_at_tied_logits_follows_the_kernel():
  """At d == 0 the JAX package forks from itself: its jnp path
  differentiates ``log1p(exp(-|d|))`` through ``abs``, whose JAX derivative
  at 0 is 1, and gets -1; its Pallas kernel returns the true derivative
  -sigmoid(0) = -0.5. The port gives -0.5 on both of its paths."""
  labels = np.array([[1.0, 0.0]], np.float32)
  logits = np.array([[0.25, 0.25]], np.float32)

  def jax_grad():
    return np.asarray(jax.grad(
        lambda s: jax_losses.PairwiseLogisticLoss()(
            jnp.asarray(labels), s, reduction='sum'))(jnp.asarray(logits)))

  pallas_ops.set_enabled(False)
  try:
    np.testing.assert_array_equal(jax_grad(), [[-1.0, 1.0]])
    pk._INTERPRET = True
    pallas_ops.set_enabled(True)
    np.testing.assert_array_equal(jax_grad(), [[-0.5, 0.5]])
  finally:
    pk._INTERPRET = False
    pallas_ops.set_enabled(None)
  for enabled in (False, True):
    tp.set_enabled(enabled)
    try:
      s = torch.from_numpy(logits.copy()).requires_grad_()
      losses.PairwiseLogisticLoss()(torch.from_numpy(labels), s,
                                    reduction='sum').backward()
    finally:
      tp.set_enabled(None)
    np.testing.assert_array_equal(s.grad.numpy(), [[-0.5, 0.5]])


def test_wrappers_count_only_kernel_launches_and_check_shapes():
  d = {k: torch.from_numpy(v) for k, v in _kernel_inputs(9).items()}
  ops = [d[k] for k in ('labels', 'logits', 'mask', 'norm_w', 'gain',
                        'ranks', 'scale')]
  static = (tp.LOSS_LOGISTIC, tp.LAMBDA_NONE, tp.DISCOUNT_INVERSE, 1e9, 0.0)
  tp.reset_launches()
  sums = tp.pairwise_sums_forward(*ops, *static)
  tp.pairwise_sums_backward(*ops, *static, d['ct'])
  with tp.plain_versions():
    again = tp.pairwise_sums_forward(*ops, *static)
  assert torch.equal(sums, again)
  assert [fn.launches for fn in tp.KERNEL_WRAPPERS] == [0, 0]  # CPU: plain
  with pytest.raises(ValueError, match='unknown'):
    tp.pairwise_sums_reference(*ops, tp.LOSS_LOGISTIC, 9, 0, 1e9, 0.0)
  with pytest.raises(ValueError, match='unknown'):
    tp.pairwise_sums_reference(*ops, 9, tp.LAMBDA_NONE, 0, 1e9, 0.0)
  with pytest.raises(ValueError, match='shared memory'):
    tp._checked(*(torch.zeros(1, tp.MAX_LIST_SIZE + 1),) * 6, torch.ones(1))
  with pytest.raises(ValueError, match='gain'):
    tp._checked(*ops[:4], ops[4][:, :3], *ops[5:])


# --- the arithmetic of the CUDA kernels' design (csrc/pairwise.cu) ----------

_ALL_MODES = [(tp.LAMBDA_NONE, tp.DISCOUNT_LOG1P_INVERSE),
              (tp.LAMBDA_LABELDIFF, tp.DISCOUNT_LOG1P_INVERSE)]
_ALL_MODES += [(mode, kind) for mode in _DCG
               for kind in (tp.DISCOUNT_LOG2_INVERSE, tp.DISCOUNT_INVERSE,
                            tp.DISCOUNT_LOG1P_INVERSE)]


def _design_inputs(seed, b=4, l=40):
  """Ragged graded lists with whole ranks in [1, L], as compute_ranks
  gives them, and unit left-item weights."""
  rng = np.random.RandomState(seed)
  labels = rng.randint(0, 5, (b, l)).astype(np.float32)
  labels[:, l // 2:] = np.where(rng.rand(b, l - l // 2) < 0.5, -1.0,
                                labels[:, l // 2:])
  valid = labels >= 0
  clean = np.where(valid, labels, 0.0).astype(np.float32)
  t = {k: torch.from_numpy(v) for k, v in dict(
      labels=labels, logits=(rng.randn(b, l) * 2).astype(np.float32),
      mask=valid.astype(np.float32), norm_w=np.ones((b, l), np.float32),
      gain=(2.0 ** clean - 1.0).astype(np.float32),
      ranks=np.stack([rng.permutation(l) + 1.0 for _ in range(b)]).astype(
          np.float32),
      scale=rng.uniform(0.5, 3.0, (b,)).astype(np.float32)).items()}
  return t


def _table_weights(d, mode, kind, topn, smooth):
  """The pair weights as the CUDA kernels' table path forms them: the
  discount terms read from (L + 1)-entry tables at |r_i - r_j| and
  max(r_i, r_j) (or each rank, for V1's capped discounts), each entry made
  by the plain version's own discount arithmetic on a whole number."""
  lab_i, lab_j = d['labels'][:, :, None], d['labels'][:, None, :]
  pw = ((lab_i - lab_j) > 0).to(torch.float32) * (
      d['mask'][:, :, None] * d['mask'][:, None, :])
  if mode == tp.LAMBDA_LABELDIFF:
    pw = pw * torch.abs(lab_i - lab_j)
  elif mode in _DCG:
    l = d['labels'].shape[1]
    k = torch.arange(l + 1, dtype=torch.float32)
    gap = torch.stack([
        torch.abs(tp._discount(kind, x[None]) - tp._discount(kind, x[None]
                                                              + 1.0))[0]
        if x > 0 else torch.tensor(0.0) for x in k])
    mult = torch.where(k > topn, torch.ones_like(k) / (
        1.0 - tp._discount(kind, k)), 1.0)
    cap = torch.where(k > topn, 0.0, tp._discount(kind, k))
    r = d['ranks'].to(torch.int64)
    r_i, r_j = r[:, :, None], r[:, None, :]
    dist = torch.abs(r_i - r_j)
    pair_gain = torch.abs(d['gain'][:, :, None] - d['gain'][:, None, :])
    if mode == tp.LAMBDA_DCG_V1:
      in_topn = (r_i <= topn) | (r_j <= topn)
      u = torch.where(in_topn, gap[dist], 0.0)
      v = torch.abs(cap[r_i] - cap[r_j])
      pair_disc = (1.0 - smooth) * u + smooth * v
      pair_disc = pair_disc * in_topn.to(torch.float32)
    else:
      pair_disc = torch.where(dist > 0, gap[dist] * mult[torch.maximum(
          r_i, r_j)], 0.0)
      if mode == tp.LAMBDA_DCG_V2_NEIGHBOR:
        pair_disc = pair_disc * (dist == 1).to(torch.float32)
    pw = pw * pair_gain * pair_disc * d['scale'][:, None, None]
  return pw * d['norm_w'][:, :, None]


def _slab_weights(d, mode, kind, topn, smooth, labels=None):
  pw, _ = tp._slab(d['labels'] if labels is None else labels, d['logits'],
                   d['mask'], d['norm_w'], d['gain'], d['ranks'], d['scale'],
                   mode, kind, topn, smooth)
  return pw


@pytest.mark.parametrize('lambda_mode,discount_kind', _ALL_MODES)
def test_table_weights_equal_the_pair_formula_bitwise(lambda_mode,
                                                      discount_kind):
  """Every table entry is bitwise what the pair formula computes, so the
  count of non-zero pair weights cannot move (topn below L: the capped and
  the multiplied discounts both occur)."""
  d = _design_inputs(seed=lambda_mode * 3 + discount_kind)
  for topn, smooth in ((7.0, 0.25), (40.0, 0.0)):
    want = _slab_weights(d, lambda_mode, discount_kind, topn, smooth)
    got = _table_weights(d, lambda_mode, discount_kind, topn, smooth)
    assert (want != 0).sum() > 0
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize('lambda_mode,discount_kind', _ALL_MODES)
def test_pair_weight_is_symmetric_bitwise(lambda_mode, discount_kind):
  """The weight of (i, j) over the left item's weight is that of (j, i):
  flipping the labels flips every preference, and the weight of each pair
  read the other way round is bitwise the same. So the backward may
  evaluate a pair's weight once and pick the item weight by the sign of
  l_i - l_j."""
  d = _design_inputs(seed=10 + lambda_mode * 3 + discount_kind)
  for topn, smooth in ((7.0, 0.25), (40.0, 0.0)):
    forward = _slab_weights(d, lambda_mode, discount_kind, topn, smooth)
    flipped = _slab_weights(d, lambda_mode, discount_kind, topn, smooth,
                            labels=torch.where(d['mask'] > 0, -d['labels'],
                                               d['labels']))
    assert (forward != 0).sum() > 0
    assert torch.equal(forward.view(torch.int32),
                       flipped.transpose(1, 2).contiguous().view(torch.int32))


def test_tiles_fill_the_card_and_cover_the_rows():
  assert tp._tiles(128, 200) == 4      # the LambdaRank step
  assert tp._tiles(16, 1024) == 32     # the long-list step
  assert tp._tiles(3, 1) == 1 and tp._tiles(1, 33) == 2
  assert tp._tiles(1024, 200) == 1
