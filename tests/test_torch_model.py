"""PyTorch port's DNN ranking model == the JAX package's, in eval mode
(train mode is held in tests/test_torch_fused_bn.py).

A flax ``RankingModel(DNNScorer(...), 'log1p')`` is initialised, given
random BN parameters and running statistics, carried over with
``convert.from_flax``, and both compute eval-mode logits on the same numpy
batch (atol 1e-5: float32 matmuls summed in another order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ranking_tpu.models import scorers as jax_scorers
from ranking_tpu_torch import convert
from ranking_tpu_torch.models import layers, scorers

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

B, L, F = 3, 7, 5


def _batch(seed=0):
  rng = np.random.RandomState(seed)
  examples = (rng.randn(B, L, F) * 3).astype(np.float32)
  context = rng.randn(B, 2).astype(np.float32)
  mask = rng.rand(B, L) > 0.3
  mask[:, 0] = True
  return context, examples, mask


def _randomize(tree, rng):
  """Random values of every leaf; variances stay positive."""
  def leaf(path, x):
    name = jax.tree_util.keystr(path)
    x = np.asarray(x)
    if 'var' in name:
      return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
    return (rng.randn(*x.shape) * 0.5).astype(np.float32)
  return jax.tree_util.tree_map_with_path(leaf, tree)


def _pair(hidden, use_batch_norm=True, input_batch_norm=False,
          with_context=False, seed=0):
  context, examples, mask = _batch(seed)
  ctx = {'c': context} if with_context else {}
  jmodel = jax_scorers.RankingModel(
      scorer=jax_scorers.DNNScorer(hidden_layer_dims=hidden,
                                   use_batch_norm=use_batch_norm,
                                   input_batch_norm=input_batch_norm),
      transform_name='log1p')
  variables = jmodel.init(jax.random.PRNGKey(seed), ctx, {'x': examples},
                          jnp.asarray(mask), training=False)
  variables = _randomize(jax.tree.map(np.asarray, dict(variables)),
                         np.random.RandomState(seed + 1))
  tmodel = scorers.RankingModel(
      scorers.DNNScorer(hidden, in_features=F + (2 if with_context else 0),
                        use_batch_norm=use_batch_norm,
                        input_batch_norm=input_batch_norm),
      transform_name='log1p')
  tmodel.load_state_dict(convert.from_flax(
      variables, input_batch_norm=input_batch_norm))
  want = jmodel.apply(variables, ctx, {'x': examples}, jnp.asarray(mask),
                      training=False)
  got = tmodel({k: torch.from_numpy(v) for k, v in ctx.items()},
               {'x': torch.from_numpy(examples)}, torch.from_numpy(mask))
  return variables, tmodel, np.asarray(want), got.detach().numpy()


@pytest.mark.parametrize('config', [
    dict(hidden=(32, 16)),
    dict(hidden=(32, 16), with_context=True),
    dict(hidden=(16,), use_batch_norm=False),
    dict(hidden=(16, 8), input_batch_norm=True),
])
def test_eval_logits_match_flax(config):
  _, _, want, got = _pair(**config)
  np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_padded_slots_score_log_epsilon():
  _, _, want, got = _pair((32, 16))
  mask = _batch()[2]
  assert np.all(got[~mask] == np.float32(layers.PADDING_LOGIT))
  np.testing.assert_allclose(got[~mask], want[~mask], rtol=1e-6)


def test_converter_layout():
  variables, tmodel, _, _ = _pair((32, 16))
  state = convert.from_flax(variables)
  tower = variables['params']['scorer']['Tower_0']
  stats = variables['batch_stats']['scorer']['Tower_0']
  # flax [in, out] kernels become torch [out, in] weights.
  np.testing.assert_array_equal(state['scorer.tower.dense.0.weight'].numpy(),
                                tower['Dense_0']['kernel'].T)
  assert state['scorer.tower.dense.0.weight'].shape == (32, F)
  # The output layer is Dense_{len(hidden)}.
  np.testing.assert_array_equal(state['scorer.tower.dense.2.weight'].numpy(),
                                tower['Dense_2']['kernel'].T)
  assert state['scorer.tower.dense.2.bias'].shape == (1,)
  np.testing.assert_array_equal(state['scorer.tower.bn.1.weight'].numpy(),
                                tower['BatchNorm_1']['scale'])
  np.testing.assert_array_equal(state['scorer.tower.bn.1.running_var'].numpy(),
                                stats['BatchNorm_1']['var'])
  assert set(state) == set(tmodel.state_dict())


def test_converter_rejects_other_models():
  with pytest.raises(ValueError, match='Tower_0'):
    convert.from_flax({'params': {'scorer': {}}})


def test_training_is_the_next_slice():
  # The training slice is ported: train mode runs, updates the running
  # statistics flax's way and leaves eval mode untouched by dropout.
  model = scorers.RankingModel(scorers.DNNScorer((4,), in_features=F,
                                                 dropout=0.0))
  context, examples, mask = _batch()
  bn = model.scorer.tower.bn[0]
  before = bn.running_mean.clone()
  logits = model({}, {'x': torch.from_numpy(examples)},
                 torch.from_numpy(mask), training=True)
  assert logits.shape == mask.shape and logits.requires_grad
  assert not torch.equal(bn.running_mean, before)
  # flax momentum 0.999 == torch momentum 0.001.
  assert bn.momentum == pytest.approx(0.001)


@pytest.mark.parametrize('name,limit', [('glorot_uniform', (6 / 48) ** .5),
                                        ('he_uniform', (6 / 16) ** .5)])
def test_named_initializers(name, limit):
  tower = layers.Tower(16, (32,), kernel_init=name,
                       generator=torch.Generator().manual_seed(0))
  w = tower.dense[0].weight
  assert w.abs().max() <= limit and w.abs().max() > 0.9 * limit
  again = layers.Tower(16, (32,), kernel_init=name,
                       generator=torch.Generator().manual_seed(0))
  assert torch.equal(again.dense[0].weight, w)
  with pytest.raises(ValueError, match='Unknown kernel_init'):
    layers.Tower(16, (32,), kernel_init='orthogonal')
