"""The port's other scorers and layers == the JAX package's, on the CPU.

``Tower`` over a 3-D input, ``GAMLayer``/``GAMScorer`` (with and without
context towers, and their sub-scores), ``rolling_group_indices``,
``scatter_group_scores`` and ``GroupwiseDNNScorer``, ``SelfAttentionMask``,
``DocumentInteractionAttention`` and ``DINScorer``, ``Bilinear``, and the
small leftovers (the gain and rank-discount registry, ``de_noise``). Each
flax model is initialised, its variables are randomised, carried over with
``convert.from_flax``, and both packages run the same numpy batch. Where the
JAX module draws random numbers (the groupwise shuffle, DIN's input noise),
one set of draws is injected into both packages.

Tolerances: forward outputs rtol 1e-5 and atol 1e-5 (float32 products
summed in another order); gradients and running statistics within 1e-4 of
each leaf's largest entry, or of the whole tree's largest entry where a
leaf is zero in theory (``_zero_in_theory``: there both packages' float32
gradients are rounding noise); integer indices exactly.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ranking_tpu.models import groupwise as jax_groupwise
from ranking_tpu.models import layers as jax_layers
from ranking_tpu.models import scorers as jax_scorers
from ranking_tpu.utils import fns as jax_fns
from ranking_tpu.utils import list_ops as jax_list_ops
from ranking_tpu_torch import convert
from ranking_tpu_torch.models import groupwise, layers, scorers
from ranking_tpu_torch.utils import fns, list_ops

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

B, L, F = 4, 9, 3
FWD = dict(rtol=1e-5, atol=1e-5)


def _batch(seed=0):
  """Features, a context feature, labels-free weights for a scalar loss and
  a mask with a list of one, an all-valid list and ragged ones."""
  rng = np.random.RandomState(seed)
  examples = (rng.randn(B, L, F) * 2).astype(np.float32)
  context = rng.randn(B, 2).astype(np.float32)
  mask = rng.rand(B, L) > 0.35
  mask[0] = False
  mask[0, 3] = True           # a list of one
  mask[1] = True              # a full list
  mask[2, :2] = True
  weights = rng.randn(B, L).astype(np.float32)
  return context, examples, mask, weights


def _randomize(tree, rng):
  """Random values of every leaf; variances and scales stay positive."""
  def leaf(path, x):
    name = jax.tree_util.keystr(path)
    x = np.asarray(x)
    if 'var' in name:
      return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
    if 'scale' in name:
      return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
    return (rng.randn(*x.shape) * 0.5).astype(np.float32)
  return jax.tree_util.tree_map_with_path(leaf, tree)


def _zero_in_theory(path, tree) -> bool:
  """A leaf whose gradient is zero in theory: a Dense bias in front of a
  BatchNorm (the batch mean removes it), a one-input Dense kernel in front
  of one (the batch variance removes its scale; zero but for the norm's
  eps), an attention's key bias (a constant of every logit of a query
  row, which the softmax removes), and the last attention layer's value and
  output biases (attention weights sum to 1, so each adds one vector to
  every row on the residual path into the tower, in front of its first
  BatchNorm)."""
  names = [p.key for p in path]
  if names[-2:] == ['key', 'bias']:
    return True
  if len(names) >= 3 and names[-1] == 'bias' and names[-2] in ('value', 'out'):
    parent = tree
    for name in names[:-3]:
      parent = parent[name]
    layers_ = [k for k in parent if k.startswith('MultiHeadDotProduct')]
    return names[-3] == max(layers_, key=lambda k: int(k.split('_')[-1]))
  if len(names) >= 2 and names[-2].startswith('Dense_'):
    parent = tree
    for name in names[:-2]:
      parent = parent[name]
    feeds_bn = f'BatchNorm_{names[-2].split("_")[1]}' in parent
    leaf = parent[names[-2]][names[-1]]
    return feeds_bn and (names[-1] == 'bias' or np.shape(leaf)[0] == 1)
  return False


def _close_tree(got, want, what):
  """Every leaf of ``want`` against ``got`` (the same tree by path): within
  1e-4 of the leaf's largest entry, or of the tree's for a leaf that is
  zero in theory."""
  flat = jax.tree_util.tree_flatten_with_path(want)[0]
  assert flat, what
  largest = max(float(np.abs(np.asarray(w)).max()) for _, w in flat)
  for path, w in flat:
    g = got
    for p in path:
      g = g[p.key]
    w, g = np.asarray(w), np.asarray(g)
    assert g.shape == w.shape, (what, jax.tree_util.keystr(path))
    scale = (largest if _zero_in_theory(path, want)
             else float(np.abs(w).max()))
    err = float(np.abs(g - w).max()) / max(scale, 1e-30)
    assert err <= 1e-4, (what, jax.tree_util.keystr(path), err)


def _t(x):
  return torch.from_numpy(np.asarray(x))


def _jax_run(jmodel, variables, args, training, rngs=None, weights=None,
             mutable=('batch_stats',)):
  """The flax model's output, its updated collections and, in training,
  the gradient of sum(weights * output) (one jitted function a case)."""
  params = variables['params']
  rest = {k: v for k, v in variables.items() if k != 'params'}

  @jax.jit
  def run(params):
    def f(params):
      out, upd = jmodel.apply({'params': params, **rest}, *args,
                              training=training, mutable=list(mutable),
                              rngs=rngs)
      main = out[0] if isinstance(out, tuple) else out
      w = jnp.ones_like(main) if weights is None else weights
      return jnp.sum(jnp.where(jnp.isfinite(main), main, 0.0) * w), (out,
                                                                     upd)
    if not training:
      return f(params)[1], None
    (_, aux), grads = jax.value_and_grad(f, has_aux=True)(params)
    return aux, grads

  (out, upd), grads = run(params)
  return jax.tree.map(np.asarray, (out, upd, grads))


def _torch_grads(model, loss):
  model.zero_grad(set_to_none=True)
  loss.backward()
  named = {n: p.grad for n, p in model.named_parameters()
           if p.grad is not None}
  return convert.to_flax(named)['params']


def _torch_stats(model):
  return convert.to_flax(dict(model.state_dict())).get('batch_stats', {})


# --- Tower on a 3-D input -------------------------------------------------

@pytest.mark.parametrize('training', [False, True])
def test_tower_on_3d_input_matches_flax(training):
  _, examples, _, weights = _batch()
  jtower = jax_layers.Tower(hidden_layer_dims=(6, 4), dropout=0.0)
  variables = jtower.init(jax.random.PRNGKey(0), examples, training=False)
  variables = _randomize(jax.tree.map(np.asarray, dict(variables)),
                         np.random.RandomState(1))
  w = weights[..., None]
  out, upd, grads = _jax_run(jtower, variables, (examples,), training,
                             weights=w)
  wrapped = {k: {'scorer': {'Tower_0': v}} for k, v in variables.items()}
  tower = layers.Tower(F, (6, 4), dropout=0.0)
  state = convert.from_flax(wrapped)
  tower.load_state_dict({k[len('scorer.tower.'):]: v
                         for k, v in state.items()})
  got = tower(_t(examples), training=training)
  assert got.shape == (B, L, 1)
  np.testing.assert_allclose(got.detach().numpy(), out, **FWD)
  if training:
    tower.zero_grad()
    torch.sum(got * _t(w)).backward()
    named = {f'scorer.tower.{n}': p.grad for n, p in tower.named_parameters()}
    _close_tree(convert.to_flax(named)['params']['scorer']['Tower_0'], grads,
                'tower gradients')
    stats = convert.to_flax({f'scorer.tower.{k}': v for k, v in
                             tower.state_dict().items()})['batch_stats']
    _close_tree(stats['scorer']['Tower_0'], upd['batch_stats'],
                'tower running statistics')


# --- GAM ------------------------------------------------------------------

def _gam_pair(with_context, seed=0):
  context, examples, mask, _ = _batch(seed)
  ex = {'a': examples[..., 0], 'b': examples[..., 1:]}   # widths 1 and 2
  ctx = {'c': context} if with_context else {}
  jmodel = jax_scorers.RankingModel(scorer=jax_scorers.GAMScorer(
      example_hidden_layer_dims=(6, 4),
      context_hidden_layer_dims=(5,) if with_context else ()))
  variables = jmodel.init(jax.random.PRNGKey(seed), ctx, ex, mask,
                          training=False)
  variables = _randomize(jax.tree.map(np.asarray, dict(variables)),
                         np.random.RandomState(seed + 1))
  tmodel = scorers.RankingModel(scorers.GAMScorer(
      (6, 4), {'a': 1, 'b': 2},
      context_widths={'c': 2} if with_context else None,
      context_hidden_layer_dims=(5,) if with_context else ()))
  tmodel.load_state_dict(convert.from_flax(variables))
  return jmodel, variables, tmodel, (ctx, ex, mask)


@pytest.mark.parametrize('with_context', [False, True])
@pytest.mark.parametrize('training', [False, True])
def test_gam_scorer_matches_flax(with_context, training):
  jmodel, variables, tmodel, args = _gam_pair(with_context)
  mask, weights = args[2], _batch()[3]
  w = np.where(mask, weights, 0.0).astype(np.float32)
  out, upd, grads = _jax_run(jmodel, variables, args, training, weights=w,
                             mutable=('batch_stats', 'intermediates'))
  inter = {}
  got = tmodel({k: _t(v) for k, v in args[0].items()},
               {k: _t(v) for k, v in args[1].items()}, _t(mask),
               training=training, intermediates=inter)
  np.testing.assert_allclose(got.detach().numpy(), out, **FWD)
  want_sub = upd['intermediates']['scorer']['gam_sub_scores'][0]
  sub = inter['gam_sub_scores'].detach().numpy()
  assert sub.shape == (B, L, 2)
  np.testing.assert_allclose(sub, want_sub, **FWD)
  if not with_context:
    # The logits are the sums of the sub-scores on the valid slots.
    np.testing.assert_allclose(got.detach().numpy()[mask],
                               sub.sum(-1)[mask], **FWD)
  if training:
    _close_tree(_torch_grads(tmodel, torch.sum(got * _t(w))), grads,
                'GAM gradients')
    _close_tree(_torch_stats(tmodel), upd['batch_stats'],
                'GAM running statistics')


def test_gam_names_and_shape_guards():
  _, variables, tmodel, args = _gam_pair(True)
  names = set(tmodel.state_dict())
  assert 'scorer.gam.example_tower_1.dense.0.weight' in names
  assert 'scorer.gam.context_tower_0.dense.1.weight' in names
  tree = convert.to_flax(dict(tmodel.state_dict()))
  gam = tree['params']['scorer']['GAMLayer_0']
  want = variables['params']['scorer']['GAMLayer_0']
  assert sorted(gam) == sorted(want)
  with pytest.raises(ValueError, match='GAMScorer over example features'):
    tmodel({}, {k: _t(v) for k, v in args[1].items()}, _t(args[2]))
  with pytest.raises(ValueError, match='Expected 2 example features'):
    tmodel.scorer.gam([_t(args[1]['a'])[..., None]], [])


@pytest.mark.parametrize('training', [False, True])
def test_gam_stacked_towers_equal_each_tower_on_its_own(training):
  """GAMLayer runs its example towers as one stack of batched products;
  each tower's sub-score is what the tower computes on its own input."""
  torch.manual_seed(0)
  gam = layers.GAMLayer([1, 3, 2], (6, 4), dropout=0.0,
                        generator=torch.Generator().manual_seed(1))
  inputs = [torch.randn(B, L, w) for w in (1, 3, 2)]
  for i in range(3):   # running statistics and scales away from the start
    tower = gam.get_submodule(f'example_tower_{i}')
    for bn in tower.bn:
      bn.running_mean.uniform_(-1, 1)
      bn.running_var.uniform_(0.5, 2)
      bn.weight.data.uniform_(0.5, 1.5)
  each = [copy.deepcopy(gam.get_submodule(f'example_tower_{i}'))
          for i in range(3)]
  _, sub = gam(inputs, training=training)
  want = torch.cat([t(x, training=training) for t, x in zip(each, inputs)],
                   dim=-1)
  np.testing.assert_allclose(sub.detach().numpy(), want.detach().numpy(),
                             **FWD)
  if training:
    for i, t in enumerate(each):
      for a, b in zip(gam.get_submodule(f'example_tower_{i}').bn, t.bn):
        assert torch.equal(a.running_mean, b.running_mean)
        assert torch.equal(a.running_var, b.running_var)
        assert torch.equal(a.num_batches_tracked, b.num_batches_tracked)


# --- groupwise ------------------------------------------------------------

@pytest.mark.parametrize('g', [1, 2, 3])
@pytest.mark.parametrize('shuffled', [False, True])
def test_rolling_group_indices_match_flax(g, shuffled, monkeypatch):
  mask = _batch()[2]
  draws = np.random.RandomState(5).rand(B, L).astype(np.float32)
  key = None
  if shuffled:
    monkeypatch.setattr(jax.random, 'uniform',
                        lambda *a, **k: jnp.asarray(draws))
    key = jax.random.PRNGKey(0)
  want_idx, want_mask = jax_groupwise.rolling_group_indices(
      jnp.asarray(mask), g, key=key)
  idx, gmask = groupwise.rolling_group_indices(
      _t(mask), g, draws=_t(draws) if shuffled else None)
  np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
  np.testing.assert_array_equal(gmask.numpy(), np.asarray(want_mask))
  valid_first = list_ops.organize_valid_indices(
      _t(mask), draws=_t(draws) if shuffled else None)
  np.testing.assert_array_equal(
      valid_first.numpy(),
      np.asarray(jax_list_ops.organize_valid_indices(jnp.asarray(mask),
                                                     key=key)))


def test_shuffled_valid_items_come_first():
  mask = _t(_batch()[2])
  draws = torch.rand(mask.shape, generator=torch.Generator().manual_seed(3))
  order = list_ops.organize_valid_indices(mask, draws=draws)
  n = mask.sum(1)
  for row in range(B):
    assert bool(mask[row, order[row, :n[row]]].all())
    assert sorted(order[row].tolist()) == list(range(L))
    # The invalid items follow in list order.
    rest = order[row, n[row]:].tolist()
    assert rest == sorted(rest)


def test_scatter_group_scores_with_fewer_valid_than_g():
  g = 3
  mask = np.zeros((2, 5), bool)
  mask[0, [1, 3]] = True      # 2 valid items < g
  mask[1, 4] = True           # 1 valid item
  scores = np.random.RandomState(2).randn(2, 5, g).astype(np.float32)
  idx, gmask = jax_groupwise.rolling_group_indices(jnp.asarray(mask), g)
  want = jax_groupwise.scatter_group_scores(jnp.asarray(scores), idx, gmask,
                                            5)
  tidx, tmask = groupwise.rolling_group_indices(_t(mask), g)
  got = groupwise.scatter_group_scores(_t(scores), tidx, tmask, 5)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
  assert np.all(got.numpy()[~mask] == 0.0)


def _groupwise_pair(g, num_shuffles=1, seed=0):
  context, examples, mask, _ = _batch(seed)
  jmodel = jax_scorers.RankingModel(scorer=jax_groupwise.GroupwiseDNNScorer(
      group_size=g, hidden_layer_dims=(8, 4), dropout=0.0,
      num_shuffles=num_shuffles))
  args = ({'c': context}, {'x': examples}, mask)
  variables = jmodel.init(jax.random.PRNGKey(seed), *args, training=False)
  variables = _randomize(jax.tree.map(np.asarray, dict(variables)),
                         np.random.RandomState(seed + 1))
  tmodel = scorers.RankingModel(groupwise.GroupwiseDNNScorer(
      2 + g * F, group_size=g, hidden_layer_dims=(8, 4), dropout=0.0,
      num_shuffles=num_shuffles))
  tmodel.load_state_dict(convert.from_flax(variables))
  return jmodel, variables, tmodel, args


@pytest.mark.parametrize('g,num_shuffles,training', [
    (2, 1, False), (3, 1, False), (2, 1, True), (2, 2, True)])
def test_groupwise_scorer_matches_flax(g, num_shuffles, training,
                                       monkeypatch):
  jmodel, variables, tmodel, args = _groupwise_pair(g, num_shuffles)
  weights = _batch()[3]
  w = np.where(args[2], weights, 0.0).astype(np.float32)
  draws = np.random.RandomState(7).rand(num_shuffles, B, L).astype(
      np.float32)
  rngs = None
  if training:
    # The JAX scorer draws each shuffle's uniforms inside make_rng; both
    # packages take these draws instead, in the same order.
    calls = iter(range(num_shuffles))
    monkeypatch.setattr(jax.random, 'uniform',
                        lambda *a, **k: jnp.asarray(draws[next(calls)]))
    rngs = {'shuffle': jax.random.PRNGKey(1)}
  out, upd, grads = _jax_run(jmodel, variables, args, training, rngs=rngs,
                             weights=w)
  got = tmodel.scorer({'c': _t(args[0]['c'])}, {'x': _t(args[1]['x'])},
                      _t(args[2]), training=training,
                      shuffle_draws=_t(draws) if training else None)
  np.testing.assert_allclose(got.detach().numpy(), out, **FWD)
  if training:
    _close_tree(_torch_grads(tmodel, torch.sum(got * _t(w))), grads,
                'groupwise gradients')
    _close_tree(_torch_stats(tmodel), upd['batch_stats'],
                'groupwise running statistics')


def test_groupwise_guards_and_generator():
  with pytest.raises(ValueError, match='num_shuffles must be >= 1'):
    groupwise.GroupwiseDNNScorer(8, num_shuffles=0)
  _, _, tmodel, args = _groupwise_pair(2)
  ctx, ex, mask = ({'c': _t(args[0]['c'])}, {'x': _t(args[1]['x'])},
                   _t(args[2]))
  with pytest.raises(ValueError, match='needs a torch.Generator'):
    tmodel(ctx, ex, mask, training=True)
  a = tmodel(ctx, ex, mask, training=True,
             generator=torch.Generator().manual_seed(4))
  b = tmodel(ctx, ex, mask, training=True,
             generator=torch.Generator().manual_seed(4))
  assert torch.equal(a, b) and torch.isfinite(a).all()


# --- DIN ------------------------------------------------------------------

def test_self_attention_mask():
  mask = _batch()[2]
  got = layers.SelfAttentionMask()(_t(mask))
  want = jax_layers.SelfAttentionMask()(jnp.asarray(mask))
  assert got.shape == (B, 1, L, L)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _din_pair(noise=0.0, seed=0):
  context, examples, mask, _ = _batch(seed)
  mask = mask.copy()
  mask[3] = False             # an all-invalid list
  jmodel = jax_scorers.RankingModel(scorer=jax_scorers.DINScorer(
      num_heads=2, head_size=6, num_attention_layers=2,
      hidden_layer_dims=(8, 4), dropout=0.0, input_noise_stddev=noise))
  args = ({'c': context}, {'x': examples}, mask)
  variables = jmodel.init(jax.random.PRNGKey(seed), *args, training=False)
  variables = _randomize(jax.tree.map(np.asarray, dict(variables)),
                         np.random.RandomState(seed + 1))
  tmodel = scorers.RankingModel(scorers.DINScorer(
      F + 2, num_heads=2, head_size=6, num_attention_layers=2,
      hidden_layer_dims=(8, 4), dropout=0.0, input_noise_stddev=noise))
  tmodel.load_state_dict(convert.from_flax(variables))
  return jmodel, variables, tmodel, args


@pytest.mark.parametrize('training,noise', [(False, 0.0), (True, 0.0),
                                            (True, 0.3)])
def test_din_scorer_matches_flax(training, noise, monkeypatch):
  jmodel, variables, tmodel, args = _din_pair(noise)
  w = np.where(args[2], _batch()[3], 0.0).astype(np.float32)
  draws = np.random.RandomState(9).randn(B, L, F + 2).astype(np.float32)
  rngs = None
  if noise:
    monkeypatch.setattr(jax.random, 'normal',
                        lambda *a, **k: jnp.asarray(draws))
    monkeypatch.setattr(scorers, '_normal', lambda *a: _t(draws))
    rngs = {'noise': jax.random.PRNGKey(2)}
  out, upd, grads = _jax_run(jmodel, variables, args, training, rngs=rngs,
                             weights=w)
  got = tmodel({'c': _t(args[0]['c'])}, {'x': _t(args[1]['x'])},
               _t(args[2]), training=training)
  assert torch.isfinite(got).all()
  np.testing.assert_allclose(got.detach().numpy(), out, **FWD)
  if training:
    _close_tree(_torch_grads(tmodel, torch.sum(got * _t(w))), grads,
                'DIN gradients')
    _close_tree(_torch_stats(tmodel), upd['batch_stats'],
                'DIN running statistics')


def test_din_names_round_trip():
  _, variables, tmodel, _ = _din_pair()
  tree = convert.to_flax(dict(tmodel.state_dict()))
  want = variables['params']['scorer']['DocumentInteractionAttention_0']
  got = tree['params']['scorer']['DocumentInteractionAttention_0']
  _close_tree(got, want, 'DIN attention parameters')
  kernel = tmodel.scorer.attention.attentions[1].out.kernel
  assert kernel.shape == (2, 3, 6)   # [heads, head_dim, F]


# --- Bilinear -------------------------------------------------------------

def test_bilinear_matches_flax():
  rng = np.random.RandomState(3)
  x = rng.randn(B, L, 4).astype(np.float32)
  y = rng.randn(B, L, 5).astype(np.float32)
  jlayer = jax_layers.Bilinear(output_units=3)
  variables = jax.tree.map(np.asarray, dict(
      jlayer.init(jax.random.PRNGKey(0), x, y)))
  variables['params']['bias'] = rng.randn(3).astype(np.float32)
  layer = layers.Bilinear(4, 5, output_units=3)
  layer.load_state_dict(convert.from_flax(variables))
  w = rng.randn(B, L, 3).astype(np.float32)

  def f(params, x, y):
    out = jlayer.apply({'params': params}, x, y)
    return jnp.sum(out * w), out
  (_, want), (g_params, g_x) = jax.value_and_grad(
      f, argnums=(0, 1), has_aux=True)(variables['params'], x, y)
  tx = _t(x).requires_grad_()
  got = layer(tx, _t(y))
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
  torch.sum(got * _t(w)).backward()
  _close_tree(convert.to_flax({n: p.grad for n, p in
                               layer.named_parameters()})['params'],
              jax.tree.map(np.asarray, g_params), 'Bilinear gradients')
  _close_tree({'x': tx.grad.numpy()}, {'x': np.asarray(g_x)},
              'Bilinear input gradient')
  # The fan-in counts both contracted axes.
  fresh = layers.Bilinear(40, 50, generator=torch.Generator().manual_seed(0))
  std = fresh.bilinear_kernel.std().item()
  assert 0.7 / (40 * 50) ** .5 < std < 1.3 / (40 * 50) ** .5


# --- small leftovers -------------------------------------------------------

@pytest.mark.parametrize('name', sorted(jax_fns.GAIN_FNS))
def test_gain_fn_registry(name):
  x = np.array([0.0, 1.0, 2.5, 4.0], np.float32)
  np.testing.assert_allclose(fns.get_gain_fn(name)(_t(x)).numpy(),
                             np.asarray(jax_fns.get_gain_fn(name)(x)), **FWD)


@pytest.mark.parametrize('name', sorted(jax_fns.RANK_DISCOUNT_FNS))
def test_rank_discount_fn_registry(name):
  r = np.arange(1, 6, dtype=np.float32)
  np.testing.assert_allclose(
      fns.get_rank_discount_fn(name)(_t(r)).numpy(),
      np.asarray(jax_fns.get_rank_discount_fn(name)(r)), **FWD)


def test_fn_registry_rejects_unknown_names():
  assert sorted(fns.GAIN_FNS) == sorted(jax_fns.GAIN_FNS)
  assert sorted(fns.RANK_DISCOUNT_FNS) == sorted(jax_fns.RANK_DISCOUNT_FNS)
  with pytest.raises(ValueError, match='Unknown gain fn'):
    fns.get_gain_fn('square')
  with pytest.raises(ValueError, match='Unknown rank discount fn'):
    fns.get_rank_discount_fn('square')


@pytest.mark.parametrize('ratio', [0.3, 0.9])
def test_de_noise_matches_flax(ratio):
  rng = np.random.RandomState(4)
  counts = rng.randint(0, 20, (3, 6)).astype(np.float32) + 1
  noise = rng.rand(3, 6).astype(np.float32) + 0.1
  want = np.asarray(jax_list_ops.de_noise(counts, noise, ratio))
  got = list_ops.de_noise(_t(counts), _t(noise), ratio).numpy()
  np.testing.assert_allclose(got, want, **FWD)
  with pytest.raises(ValueError, match='ratio must be in'):
    list_ops.de_noise(_t(counts), _t(noise), 1.0)
