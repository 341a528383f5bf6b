"""The port's train state and train step == the JAX package's, on the CPU.

Three steps of ``make_train_step`` (DNNScorer with batch norm, 'log1p',
``softmax_loss``, Adam 1e-3) run in both packages from the same converted
weights on the same numpy batches, on both BN paths; the loss, the sanity
metrics, every parameter and the running statistics are compared after each
step (rtol 1e-5; atol 1e-6, and 5e-6 on parameters: float32 sums in another
order, chained through a backward pass). Two steps of the LambdaRank recipe
(``pairwise_logistic_loss`` with the NDCG lambda weight) are held the same
way, with the port's fused pairwise sums on and off.

Adam's eps is 1e-3 in that test, in both packages. This model has
parameters whose true gradient is zero: a Dense bias in front of a batch
norm, and the output bias under a shift-invariant softmax loss. Their
computed gradients are rounding noise (1e-10), and with the default eps of
1e-8 Adam's first steps would turn that noise into moves of a whole
learning rate, in directions that differ between any two implementations.
An eps above the noise keeps the comparison about the arithmetic. That the
port's Adam equals ``optax.adam`` at the default eps is its own test.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ranking_tpu.data import batch as jax_batch
from ranking_tpu.models import scorers as jax_scorers
from ranking_tpu.ops import lambda_weights as jax_lw
from ranking_tpu.ops import loss_registry as jax_registry
from ranking_tpu.ops.pallas import fused_bn as jfb
from ranking_tpu.train import state as jax_state
from ranking_tpu.train import steps as jax_steps
from ranking_tpu_torch import convert
from ranking_tpu_torch.data import batch as batch_lib
from ranking_tpu_torch.data import dataset
from ranking_tpu_torch.models import layers, scorers
from ranking_tpu_torch.ops import lambda_weights as lw
from ranking_tpu_torch.ops import loss_registry
from ranking_tpu_torch.ops.cuda import fused_bn as tfb
from ranking_tpu_torch.ops.cuda import pairwise as tpw
from ranking_tpu_torch.train import state as state_lib
from ranking_tpu_torch.train import steps

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

B, L, F = 4, 6, 8
HIDDEN = (16, 8)


def _batches(num, seed=0):
  rng = np.random.RandomState(seed)
  out = []
  for _ in range(num):
    mask = rng.rand(B, L) > 0.3
    mask[:, 0] = True
    labels = np.where(mask, rng.randint(0, 5, (B, L)), -1).astype(np.float32)
    labels[0] = np.where(mask[0], 0.0, -1.0)  # a list with no relevant item
    out.append((rng.randn(B, L, F).astype(np.float32) * 2, labels, mask))
  return out


def _randomized(variables, seed):
  rng = np.random.RandomState(seed)

  def leaf(path, x):
    x = np.asarray(x)
    if 'var' in jax.tree_util.keystr(path):
      return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
    return (rng.randn(*x.shape) * 0.3).astype(np.float32)
  return jax.tree_util.tree_map_with_path(leaf, variables)


def _assert_trees_close(got, want, atol):
  flat_want = jax.tree_util.tree_leaves_with_path(want)
  flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
  assert len(flat_want) == len(flat_got)
  for path, w in flat_want:
    np.testing.assert_allclose(flat_got[path], np.asarray(w), rtol=1e-5,
                               atol=atol, err_msg=jax.tree_util.keystr(path))


def _assert_steps_match(jloss_fn, tloss_fn, fused, num_steps, logit_scale=1.0):
  """Runs ``num_steps`` train steps in both packages from the same weights
  on the same batches and compares the metrics, the parameters and the
  running statistics after each."""
  jfb.set_enabled(fused)
  tfb.set_enabled(fused)
  try:
    batches = _batches(num_steps)
    jmodel = jax_scorers.RankingModel(
        scorer=jax_scorers.DNNScorer(hidden_layer_dims=HIDDEN, dropout=0.0,
                                     input_grad=False),
        transform_name='log1p')
    x0, _, m0 = batches[0]
    tx = optax.adam(1e-3, eps=1e-3)
    jstate = jax_state.create_train_state(
        jmodel, tx, jax.random.PRNGKey(0), {}, {'x': x0}, jnp.asarray(m0))
    variables = _randomized(
        jax.tree.map(np.asarray, dict(jstate.variables)), 1)
    # A smaller output layer keeps the logits small where a test wants that.
    tower = variables['params']['scorer']['Tower_0']
    out_layer = f'Dense_{len(HIDDEN)}'
    tower[out_layer] = jax.tree.map(lambda a: a * np.float32(logit_scale),
                                    tower[out_layer])
    jstate = jstate.replace(params=variables['params'],
                            batch_stats=variables['batch_stats'],
                            opt_state=tx.init(variables['params']))
    jstep = jax.jit(jax_steps.make_train_step(jloss_fn))

    tmodel = scorers.RankingModel(
        scorers.DNNScorer(HIDDEN, in_features=F, dropout=0.0,
                          input_grad=False), transform_name='log1p')
    tmodel.load_state_dict(convert.from_flax(variables))
    tstate = state_lib.create_train_state(
        tmodel, state_lib.adam(1e-3, eps=1e-3), device='cpu')
    tstep = steps.make_train_step(tloss_fn, device='cpu')

    for i, (x, labels, mask) in enumerate(batches):
      jb = jax_batch.RankingBatch(context={}, examples={'x': jnp.asarray(x)},
                                  labels=jnp.asarray(labels),
                                  mask=jnp.asarray(mask))
      jstate, want = jstep(jstate, jb, jax.random.PRNGKey(7))
      tb = dataset.flatten_examples(batch_lib.batch_from_labels(
          labels, examples={'x': x}, mask=mask))  # the flat feed
      tstate, got = tstep(tstate, tb)
      assert tstate.step == i + 1 == int(jstate.step)
      for name in ('loss', 'labels_mean', 'logits_mean'):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
      tree = convert.to_flax(tstate.model.state_dict())
      _assert_trees_close(tree['params'], jstate.params, atol=5e-6)
      _assert_trees_close(tree['batch_stats'], jstate.batch_stats, atol=1e-6)
    return got
  finally:
    jfb.set_enabled(None)
    tfb.set_enabled(None)


@pytest.mark.parametrize('fused', [True, False])
def test_three_train_steps_match_jax(fused):
  _assert_steps_match(jax_registry.make_loss_fn('softmax_loss'),
                      loss_registry.make_loss_fn('softmax_loss'), fused, 3)


@pytest.mark.parametrize('fused_pairwise', [True, False])
def test_lambdarank_train_step_matches_jax(fused_pairwise):
  """``pairwise_logistic_loss`` with the NDCG lambda weight: two steps, the
  same tolerances as the softmax step. The JAX step always hands its loss a
  key, which shuffles rank ties; the port's step runs with no generator.
  With distinct, small logits (the output layer is scaled by 0.1, so that
  the row minimum minus 1e-6 stays below the minimum in float32) only the
  invalid items tie, and they carry no pair weight. The port's fused sums
  are forced on (their plain version, on the CPU) and off."""
  tpw.set_enabled(fused_pairwise)
  try:
    got = _assert_steps_match(
        jax_registry.make_loss_fn(
            'pairwise_logistic_loss',
            lambda_weight=jax_lw.create_ndcg_lambda_weight()),
        loss_registry.make_loss_fn(
            'pairwise_logistic_loss',
            lambda_weight=lw.create_ndcg_lambda_weight()),
        fused=True, num_steps=2, logit_scale=0.1)
    assert got['loss'].item() > 0
  finally:
    tpw.set_enabled(None)


def test_adam_matches_optax_over_five_steps():
  rng = np.random.RandomState(0)
  params = {'a': rng.randn(5, 3).astype(np.float32),
            'b': rng.randn(7).astype(np.float32)}
  grads = [{k: (rng.randn(*v.shape) * 10 ** rng.uniform(-3, 1)).astype(
      np.float32) for k, v in params.items()} for _ in range(5)]
  tx = optax.adam(1e-3)
  jparams = jax.tree.map(jnp.asarray, params)
  opt_state = tx.init(jparams)
  tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
             for k, v in params.items()}
  opt = state_lib.adam(1e-3)(tparams.values())
  for g in grads:
    updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state,
                                   jparams)
    jparams = optax.apply_updates(jparams, updates)
    for k, p in tparams.items():
      p.grad = torch.from_numpy(g[k].copy())
    opt.step()
    for k in params:
      np.testing.assert_allclose(tparams[k].detach().numpy(),
                                 np.asarray(jparams[k]), rtol=1e-6,
                                 atol=1e-7)


def test_multi_step_equals_single_steps():
  batches = [dataset.flatten_examples(batch_lib.batch_from_labels(
      labels, examples={'x': x}, mask=mask))
             for x, labels, mask in _batches(3, seed=3)]
  loss_fn = loss_registry.make_loss_fn('softmax_loss')

  def fresh():
    gen = torch.Generator().manual_seed(0)
    model = scorers.RankingModel(
        scorers.DNNScorer(HIDDEN, in_features=F, dropout=0.0, generator=gen))
    return state_lib.create_train_state(model, device='cpu')
  step = steps.make_train_step(loss_fn, device='cpu')
  single = fresh()
  want = [step(single, b)[1] for b in batches]
  multi = fresh()
  multi, got = steps.make_multi_step(step, device='cpu')(
      multi, steps.stack_batches(batches))
  assert multi.step == 3 and got['loss'].shape == (3,)
  for name in got:
    torch.testing.assert_close(got[name], torch.stack([m[name]
                                                       for m in want]))
  for a, b in zip(single.model.parameters(), multi.model.parameters()):
    torch.testing.assert_close(a, b)


def test_state_addresses_see_what_a_captured_step_is_bound_to():
  """A captured step is bound to the addresses of the state's tensors:
  in-place steps keep them, and a created or restored optimizer state, a
  replaced parameter or buffer or a new rate tensor changes them."""
  (x, labels, mask), = _batches(1, seed=4)
  batch = dataset.flatten_examples(batch_lib.batch_from_labels(
      labels, examples={'x': x}, mask=mask))
  model = scorers.RankingModel(scorers.DNNScorer(
      HIDDEN, in_features=F, dropout=0.0,
      generator=torch.Generator().manual_seed(0)))
  state = state_lib.create_train_state(model, device='cpu')
  step = steps.make_train_step(loss_registry.make_loss_fn('softmax_loss'),
                               device='cpu')
  fresh = steps.state_addresses(state)
  step(state, batch)  # creates Adam's moments
  after_one = steps.state_addresses(state)
  assert after_one != fresh
  step(state, batch)
  assert steps.state_addresses(state) == after_one
  # A restored checkpoint brings new moment tensors.
  state.optimizer.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
  restored = steps.state_addresses(state)
  assert restored != after_one and len(restored) == len(after_one)
  state.model.scorer.tower.bn[0].running_mean = torch.zeros(HIDDEN[0])
  assert steps.state_addresses(state) != restored


def test_total_loss_over_tasks():
  with pytest.raises(ValueError, match='unknown tasks'):
    steps.make_train_step({'a': lambda *a, **k: 0.0}, {'b': 1.0},
                          device='cpu')
  total = steps._make_total_loss(
      {'a': lambda l, s, features=None, generator=None: s.sum(),
       'b': lambda l, s, features=None, generator=None: 2 * s.sum()},
      {'b': 0.5})
  logits = {'a': torch.ones(2), 'b': torch.ones(3)}
  assert total({'a': None, 'b': None}, logits, None).item() == 2 + 3
  # Every task's loss is handed the step's generator.
  seen = []
  total = steps._make_total_loss(
      {'a': lambda l, s, features=None, generator=None:
       seen.append(generator) or s.sum()}, None)
  gen = torch.Generator()
  total({'a': None}, logits, None, gen)
  assert seen == [gen]
  # A batch with per-task labels moves between devices like any other.
  tasks = batch_lib.RankingBatch(context={}, examples={},
                                 labels={'a': torch.zeros(1, 2)},
                                 mask=torch.ones(1, 2, dtype=torch.bool))
  assert set(tasks.to('cpu').labels) == {'a'}


def test_dropout_rate_scale_and_seed():
  """JAX's random bits cannot be had, so dropout is held to its rate, its
  scale and its determinism under one generator seed."""
  rate = 0.3
  mask = layers.dropout_mask((200, 100), rate,
                             torch.Generator().manual_seed(1), 'cpu')
  kept = mask != 0
  assert abs(kept.float().mean().item() - (1 - rate)) < 0.02
  torch.testing.assert_close(mask[kept],
                             torch.full_like(mask[kept], 1 / (1 - rate)))
  again = layers.dropout_mask((200, 100), rate,
                              torch.Generator().manual_seed(1), 'cpu')
  assert torch.equal(mask, again)

  tower = layers.Tower(F, (16,), dropout=rate,
                       generator=torch.Generator().manual_seed(0))
  x = torch.randn(50, F, generator=torch.Generator().manual_seed(2))
  a = tower(x, training=True, generator=torch.Generator().manual_seed(3))
  b = tower(x, training=True, generator=torch.Generator().manual_seed(3))
  c = tower(x, training=True, generator=torch.Generator().manual_seed(4))
  assert torch.equal(a, b) and not torch.equal(a, c)
  with pytest.raises(ValueError, match='Generator'):
    tower(x, training=True)
  tower(x, training=False)  # eval needs none
