"""The port's fused masked-BN tower == the JAX package's, on the CPU.

On the CPU the port's wrappers compute their plain PyTorch versions; the
JAX side runs its Pallas kernels in interpret mode
(``fused_bn.set_enabled(True)``, as tests/test_pallas_fused_bn.py does).
Inputs come from numpy with a seed and go through both.

Tolerances. float32: rtol/atol 1e-5 forward, 1e-4 gradients (sums in
another order; gradients chain three layers of them). bfloat16
``act_dtype``: stored activations may differ by one bf16 ulp (2^-8
relative), so 1e-2 of the largest value for them and 2e-3 for float32
sums of bf16 products.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ranking_tpu.models import layers as jax_layers
from ranking_tpu.models import scorers as jax_scorers
from ranking_tpu.ops.pallas import fused_bn as jfb
from ranking_tpu_torch import convert
from ranking_tpu_torch.models import layers, scorers
from ranking_tpu_torch.ops.cuda import fused_bn as tfb

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

F0, F1, F2 = 16, 32, 16
TILE = jfb.TILE_N  # the JAX callers pad rows to a multiple of this


@pytest.fixture(autouse=True)
def _force_fused():
  jfb.set_enabled(True)
  tfb.set_enabled(True)
  yield
  jfb.set_enabled(None)
  tfb.set_enabled(None)


def _t(x, dtype=None):
  t = torch.from_numpy(np.array(x, dtype=np.float32))
  return t if dtype is None else t.to(dtype)


def _np(x):
  if isinstance(x, torch.Tensor):
    return x.detach().to(torch.float32).numpy()
  return np.asarray(jnp.asarray(x, jnp.float32))


def _pad(a, n_pad):
  return np.concatenate(
      [a, np.zeros((n_pad - a.shape[0],) + a.shape[1:], a.dtype)])


def _close(got, want, tol, scale_by_max=False):
  got, want = _np(got), _np(want)
  atol = tol * (np.abs(want).max() if scale_by_max else 1.0)
  np.testing.assert_allclose(got, want, rtol=tol, atol=atol)


# --- rows 2-6, one by one ---------------------------------------------------


@functools.partial(jax.jit, static_argnames=('act',))
def _jax_rows(x0, mask, w0, b0, s0, t0, w1, b1, g, s, t, c1, c2, act):
  """Every Pallas function of the module on one set of padded inputs."""
  ones, zeros = jnp.ones((F0,)), jnp.zeros((F0,))
  y0, sum0, ssq0 = jfb._layer_forward(x0, mask, ones, zeros, w0, b0,
                                      relu_in=False, act_dtype=act)
  y1, sum1, ssq1 = jfb._layer_forward(y0, mask, s0, t0, w1, b1,
                                      relu_in=True, act_dtype=act)
  g = g.astype(act)
  stats = jfb._bwd_stats(g, y1, s, t)
  mats = jfb._bwd_mats(g, y1, mask, s, t, c1, c2, y0, s0, t0, w1,
                       relu_in=True, emit_prev_stats=True, x0=x0)
  g0 = mats[0]
  dx_only = jfb._bwd_dx_only(g0, y0, mask, s0, t0, c1[:1] * s0, c2[:1] * s0,
                             w0)
  dw_only = jfb._bwd_dw_only(g0, y0, mask, s0, t0, c1[:1] * s0, c2[:1] * s0,
                             x0, ones, zeros, relu_in=False)
  return (y0, sum0, ssq0), (y1, sum1, ssq1), stats, mats, dx_only, dw_only


@pytest.mark.parametrize('act', ['float32', 'bfloat16'])
@pytest.mark.parametrize('n', [512, 700])
def test_each_plain_version_matches_its_pallas_function(n, act):
  rng = np.random.RandomState(n)
  n_pad = -(-n // TILE) * TILE
  f = lambda *shape, scale=1.0: (rng.randn(*shape) * scale).astype(  # noqa: E731
      np.float32)
  x0, mask = f(n, F0), (rng.rand(n, 1) > 0.3).astype(np.float32)
  w0, b0, w1, b1 = f(F0, F1, scale=.3), f(F1, scale=.1), f(F1, F2, scale=.2), \
      f(F2, scale=.1)
  s0, t0 = 1 + f(F1, scale=.1), f(F1, scale=.1)
  g, s, t = f(n, F2), 1 + f(F2, scale=.1), f(F2, scale=.1)
  c1, c2 = f(F2, scale=.01), f(F2, scale=.01)
  jact = jnp.dtype(act)
  tact = getattr(torch, act)
  want = _jax_rows(_pad(x0, n_pad), _pad(mask, n_pad), w0, b0, s0, t0, w1, b1,
                   _pad(g, n_pad), s, t, c1, c2, act=jact)
  stored, summed = (1e-5, 1e-5) if act == 'float32' else (1e-2, 2e-3)

  tx0, tmask = _t(x0), _t(mask)
  ones, zeros = torch.ones(F0), torch.zeros(F0)
  # Row 2. Each later call takes the JAX side's activations as its input, so
  # that one row's rounding does not leak into the next comparison.
  got = tfb.layer_forward(tx0, tmask, ones, zeros, _t(w0), _t(b0),
                          relu_in=False, act_dtype=tact)
  _close(got[0], want[0][0][:n], stored, True)
  _close(got[1], want[0][1], summed, True)
  _close(got[2], want[0][2], summed, True)
  y0 = _t(_np(want[0][0])[:n], tact)
  got = tfb.layer_forward(y0, tmask, _t(s0), _t(t0), _t(w1), _t(b1),
                          relu_in=True, act_dtype=tact)
  _close(got[0], want[1][0][:n], stored, True)
  _close(got[1], want[1][1], summed, True)
  _close(got[2], want[1][2], summed, True)
  y1 = _t(_np(want[1][0])[:n], tact)
  # Row 3.
  tg = _t(g, tact)
  got = tfb.bwd_stats(tg, y1, _t(s), _t(t))
  _close(got[0], want[2][0], summed, True)
  _close(got[1], want[2][1], summed, True)
  # Row 4, with the first-layer fold.
  got = tfb.bwd_mats(tg, y1, tmask, _t(s), _t(t), _t(c1), _t(c2), y0, _t(s0),
                     _t(t0), _t(w1), relu_in=True, emit_prev_stats=True,
                     x0=tx0)
  assert got[0].dtype == tact and got[1].shape == (F1, F2)
  _close(got[0], want[3][0][:n], stored, True)
  for got_i, want_i in zip(got[1:], want[3][1:]):
    _close(got_i, want_i, summed, True)
  # Rows 5 and 6, on row 4's dx.
  g0 = _t(_np(want[3][0])[:n], tact)
  k1, k2 = _t(c1[:1] * s0), _t(c2[:1] * s0)
  got = tfb.bwd_dx_only(g0, y0, tmask, _t(s0), _t(t0), k1, k2, _t(w0))
  assert got.dtype == torch.float32
  _close(got, want[4][:n], summed, True)
  got = tfb.bwd_dw_only(g0, y0, tmask, _t(s0), _t(t0), k1, k2, tx0, ones,
                        zeros, relu_in=False)
  _close(got, want[5], summed, True)


def test_bwd_mats_options():
  rng = np.random.RandomState(3)
  f = lambda *shape: _t(rng.randn(*shape) * .3)  # noqa: E731
  n = 40
  args = (f(n, F2), f(n, F2), _t(rng.rand(n) > .3), 1 + f(F2), f(F2), f(F2),
          f(F2), f(n, F1), 1 + f(F1), f(F1), f(F1, F2))
  full = tfb.bwd_mats(*args, relu_in=True, emit_prev_stats=True,
                      x0=f(n, F0))
  assert len(full) == 6 and full[4].shape == (F0, F1)
  no_dx = tfb.bwd_mats(*args, relu_in=True, emit_prev_stats=True,
                       x0=f(n, F0), emit_dx=False)
  assert no_dx[0] is None
  torch.testing.assert_close(no_dx[1], full[1])
  no_stats = tfb.bwd_mats(*args, relu_in=False, emit_prev_stats=False)
  assert no_stats[2] is None and no_stats[3] is None
  with pytest.raises(ValueError, match='only feed'):
    tfb.bwd_mats(*args, relu_in=True, emit_prev_stats=True, emit_dx=False)


# --- the whole op -------------------------------------------------------------


def _mlp(seed, n, dims, masked=True):
  rng = np.random.RandomState(seed)
  x = rng.randn(n, dims[0]).astype(np.float32)
  mask = ((rng.rand(n) > 0.35) if masked else np.ones(n)).astype(np.float32)
  ws, bs, gs, betas = [], [], [], []
  for f_in, f_out in zip(dims[:-1], dims[1:]):
    ws.append((rng.randn(f_in, f_out) * 0.2).astype(np.float32))
    bs.append((rng.randn(f_out) * 0.1).astype(np.float32))
    gs.append((1.0 + 0.1 * rng.randn(f_out)).astype(np.float32))
    betas.append((0.1 * rng.randn(f_out)).astype(np.float32))
  cot = rng.randn(n, dims[-1]).astype(np.float32)
  return x, mask, ws, bs, gs, betas, cot


@functools.partial(jax.jit, static_argnames=('act', 'input_grad', 'pallas'))
def _jax_op(x, mask, ws, bs, gs, betas, cot, act, input_grad, pallas):
  def loss(x, ws, bs, gs, betas):
    if pallas:
      out, means, vars_ = jfb.fused_bn_mlp(x, mask, ws, bs, gs, betas, 1e-5,
                                           act_dtype=act,
                                           input_grad=input_grad)
    else:
      out, means, vars_ = jfb.reference_bn_mlp(x, ws, bs, gs, betas,
                                               mask=mask)
    return jnp.sum(out.astype(jnp.float32) * cot), (out, means, vars_)
  return jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
      x, tuple(ws), tuple(bs), tuple(gs), tuple(betas))


def _torch_op(x, mask, ws, bs, gs, betas, cot, act, input_grad):
  leaf = lambda a: _t(a).requires_grad_()  # noqa: E731
  tx = leaf(x)
  params = [[leaf(w.T) for w in ws], [leaf(b) for b in bs],
            [leaf(g) for g in gs], [leaf(b) for b in betas]]
  out, means, vars_ = tfb.fused_bn_mlp(tx, _t(mask), *params, 1e-5,
                                       act_dtype=act, input_grad=input_grad)
  assert not any(m.requires_grad for m in means + vars_)
  (out.to(torch.float32) * _t(cot)).sum().backward()
  dx = tx.grad if input_grad else None
  assert input_grad or tx.grad is None
  grads = [[p.grad.T if p.ndim == 2 else p.grad for p in group]
           for group in params]
  return out, means, vars_, dx, grads


@pytest.mark.parametrize('n,dims,input_grad,oracle', [
    (512, (F0, F1, F2), True, 'pallas'),
    (700, (F0, F1, F2), False, 'pallas'),
    (700, (F0, F1, F2, 8), True, 'pallas'),
    (700, (F0, F1), True, 'pallas'),
    (512, (F0, F1), False, 'pallas'),
    (700, (F0, F1, F2), True, 'reference'),
    (700, (F0, F1), True, 'reference'),
])
def test_fused_op_matches_jax(n, dims, input_grad, oracle):
  """Forward, means, vars and all gradients against the Pallas op and
  against autodiff of the masked jnp mirror, with a ragged mask."""
  x, mask, ws, bs, gs, betas, cot = _mlp(n + len(dims), n, dims)
  (_, (want_out, want_means, want_vars)), want_grads = _jax_op(
      x, mask, ws, bs, gs, betas, cot, act=jnp.float32,
      input_grad=input_grad, pallas=oracle == 'pallas')
  out, means, vars_, dx, grads = _torch_op(x, mask, ws, bs, gs, betas, cot,
                                           torch.float32, input_grad)
  _close(out, want_out, 1e-5)
  for got, want in zip(means + vars_, want_means + want_vars):
    _close(got, want, 1e-5)
  if input_grad:
    _close(dx, want_grads[0], 1e-4, True)
  for group, want_group in zip(grads, want_grads[1:]):
    for got, want in zip(group, want_group):
      # Bias gradients are exactly 0 in theory (BN removes the shift):
      # both sides hold rounding noise, far below the other gradients.
      _close(got, want, 1e-4, True) if np.abs(_np(want)).max() > 1e-3 else \
          np.testing.assert_allclose(_np(got), _np(want), atol=1e-3)


def test_fused_op_bf16_matches_pallas():
  n, dims = 512, (F0, F1, F2)
  x, mask, ws, bs, gs, betas, cot = _mlp(11, n, dims)
  (_, (want_out, want_means, want_vars)), want_grads = _jax_op(
      x, mask, ws, bs, gs, betas, cot, act=jnp.bfloat16, input_grad=True,
      pallas=True)
  out, means, vars_, dx, grads = _torch_op(x, mask, ws, bs, gs, betas, cot,
                                           torch.bfloat16, True)
  assert out.dtype == torch.bfloat16
  # Looser: the two sides round y to bf16 after sums in another order, and
  # a one-ulp difference in a stored activation feeds every later layer.
  _close(out, want_out, 2e-2, True)
  for got, want in zip(means + vars_, want_means + want_vars):
    _close(got, want, 1e-2, True)
  _close(dx, want_grads[0], 5e-2, True)
  for group, want_group in zip(grads[:1] + grads[2:],
                               want_grads[1:2] + want_grads[3:]):
    for got, want in zip(group, want_group):
      _close(got, want, 5e-2, True)


def test_reference_bn_mlp_matches_jax_mirror():
  x, mask, ws, bs, gs, betas, _ = _mlp(5, 300, (F0, F1, F2))
  want = jfb.reference_bn_mlp(jnp.asarray(x), ws, bs, gs, betas, mask=mask)
  got = tfb.reference_bn_mlp(_t(x), [_t(w.T) for w in ws],
                             [_t(b) for b in bs], [_t(g) for g in gs],
                             [_t(b) for b in betas], mask=_t(mask))
  _close(got[0], want[0], 1e-5)
  for g, w in zip(got[1] + got[2], want[1] + want[2]):
    _close(g, w, 1e-5)


@pytest.mark.parametrize('mask_kind', ['ones', 'zeros'])
def test_fused_op_degenerate_masks(mask_kind):
  """All-ones is plain BN; all-zero divides by max(count, 1) = 1."""
  x, _, ws, bs, gs, betas, cot = _mlp(9, 200, (F0, F1, F2))
  mask = np.ones(200, np.float32) if mask_kind == 'ones' else np.zeros(
      200, np.float32)
  out, means, vars_, _, grads = _torch_op(x, mask, ws, bs, gs, betas, cot,
                                          torch.float32, True)
  want, want_means, want_vars = jfb.reference_bn_mlp(
      jnp.asarray(x), ws, bs, gs, betas, mask=mask)
  _close(out, want, 1e-5, True)
  for got, w in zip(means + vars_, want_means + want_vars):
    _close(got, w, 1e-5)
  assert all(torch.isfinite(g).all() for group in grads for g in group)


def test_switch_and_eligibility():
  x = torch.zeros(4, F0)
  ok = dict(training=True, use_batch_norm=True, input_batch_norm=False,
            dropout=0.0, activation='relu', dtype=torch.float32, x=x)
  assert tfb.eligible(**ok)
  for change in (dict(training=False), dict(use_batch_norm=False),
                 dict(input_batch_norm=True), dict(dropout=0.1),
                 dict(activation='tanh'), dict(dtype=torch.float16),
                 dict(x=x.to(torch.float64)), dict(x=x[None])):
    assert not tfb.eligible(**{**ok, **change})
  tfb.set_enabled(None)   # default: fused only for CUDA tensors
  assert not tfb.eligible(**ok)
  tfb.set_enabled(False)
  assert not tfb.eligible(**ok)
  for n, n_i, n_j in ((25600, 512, 1024), (700, 32, 16), (5, 300, 300)):
    splits, chunk = tfb.row_splits(n, n_i, n_j)
    assert splits >= 1 and splits * chunk >= n > (splits - 1) * chunk
    assert chunk % 32 == 0  # a multiple of the kernels' slice depth
  # One wave of one block a multiprocessor: 32 tiles x 4 and, with one
  # 136-wide tile across F_0 = 136, 8 tiles x 16, within 132 blocks.
  assert tfb.row_splits(25600, 512, 1024)[0] == 4
  assert tfb.row_splits(25600, 1024, 136)[0] == 16


# --- Tower and DNNScorer in train mode, both BN paths ---------------------


B, L = 4, 6


def _batch(seed):
  rng = np.random.RandomState(seed)
  examples = (rng.randn(B, L, F0) * 2).astype(np.float32)
  mask = rng.rand(B, L) > 0.3
  mask[:, 0] = True
  return examples, mask


def _randomized(variables, seed):
  rng = np.random.RandomState(seed)

  def leaf(path, x):
    x = np.asarray(x)
    if 'var' in jax.tree_util.keystr(path):
      return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
    return (rng.randn(*x.shape) * 0.3).astype(np.float32)
  return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.mark.parametrize('fused', [True, False])
@pytest.mark.parametrize('hidden', [(F1, F2), (F1,)])
def test_dnn_scorer_train_mode_matches_flax(fused, hidden):
  """Train-mode logits, input-side gradients of every parameter and the
  updated running statistics, on the fused path (row mask, exact masked
  moments) and the unfused one (circular padding, flax BatchNorm)."""
  jfb.set_enabled(fused)
  tfb.set_enabled(fused)
  examples, mask = _batch(len(hidden))
  jmodel = jax_scorers.RankingModel(
      scorer=jax_scorers.DNNScorer(hidden_layer_dims=hidden, dropout=0.0),
      transform_name='log1p')
  variables = jmodel.init(jax.random.PRNGKey(0), {}, {'x': examples},
                          jnp.asarray(mask), training=False)
  variables = _randomized(jax.tree.map(np.asarray, dict(variables)), 1)
  cot = np.random.RandomState(2).randn(B, L).astype(np.float32)

  def loss(params):
    logits, updated = jmodel.apply(
        {'params': params, 'batch_stats': variables['batch_stats']}, {},
        {'x': examples}, jnp.asarray(mask), training=True,
        mutable=['batch_stats'])
    return jnp.sum(logits * cot * mask), (logits, updated['batch_stats'])
  (_, (want_logits, want_stats)), want_grads = jax.value_and_grad(
      loss, has_aux=True)(variables['params'])

  tmodel = scorers.RankingModel(
      scorers.DNNScorer(hidden, in_features=F0, dropout=0.0),
      transform_name='log1p')
  tmodel.load_state_dict(convert.from_flax(variables))
  tmask = torch.from_numpy(mask)
  logits = tmodel({}, {'x': torch.from_numpy(examples)}, tmask,
                  training=True)
  (logits * _t(cot) * tmask).sum().backward()
  _close(logits, want_logits, 1e-5)
  got = convert.to_flax(tmodel.state_dict())
  got_grads = convert.to_flax(
      {k: p.grad for k, p in tmodel.named_parameters()})
  for g, w in zip(jax.tree.leaves(got['batch_stats']),
                  jax.tree.leaves(want_stats)):
    _close(g, w, 1e-6)
  flat_want = jax.tree_util.tree_leaves_with_path(want_grads)
  flat_got = dict(jax.tree_util.tree_leaves_with_path(got_grads['params']))
  assert len(flat_want) == len(flat_got)
  for path, w in flat_want:
    np.testing.assert_allclose(flat_got[path], np.asarray(w), rtol=1e-4,
                               atol=1e-4 * max(1.0, np.abs(w).max()))


def test_tower_unfused_options_match_flax():
  """input_batch_norm, tanh and no BN take the unfused chain on both
  sides; the input's gradient follows ``input_grad``."""
  rng = np.random.RandomState(4)
  x = rng.randn(30, F0).astype(np.float32)
  jtower = jax_layers.Tower(hidden_layer_dims=(F1,), activation='tanh',
                            input_batch_norm=True, dropout=0.0)
  variables = jtower.init(jax.random.PRNGKey(0), x, training=False)
  variables = _randomized(jax.tree.map(np.asarray, dict(variables)), 5)
  want, updated = jtower.apply(variables, x, training=True,
                               mutable=['batch_stats'])
  ttower = layers.Tower(F0, (F1,), activation='tanh', input_batch_norm=True,
                        dropout=0.0, input_grad=False)
  state = convert.from_flax(
      {'params': {'scorer': {'Tower_0': variables['params']}},
       'batch_stats': {'scorer': {'Tower_0': variables['batch_stats']}}},
      input_batch_norm=True)
  ttower.load_state_dict({k[len('scorer.tower.'):]: v
                          for k, v in state.items()})
  tx = _t(x).requires_grad_()
  got = ttower(tx, training=True)
  _close(got, want, 1e-5)
  got.sum().backward()
  assert tx.grad is None  # input_grad=False is a detach on this path too
  stats = updated['batch_stats']
  _close(ttower.input_bn.running_mean, stats['BatchNorm_0']['mean'], 1e-6)
  _close(ttower.input_bn.running_var, stats['BatchNorm_0']['var'], 1e-6)
  _close(ttower.bn[0].running_var, stats['BatchNorm_1']['var'], 1e-6)
  assert int(ttower.bn[0].num_batches_tracked) == 1
