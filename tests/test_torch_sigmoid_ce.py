"""Sigmoid cross-entropy at a logit of exactly 0: the port's gradient is the
JAX package's, on the CPU.

The formula ``max(x, 0) - x * y + log1p(exp(-|x|))`` has a kink at 0 in two
terms. ``jnp.maximum`` splits a tie's gradient evenly and ``jnp.abs``'s
derivative at 0 is +1, so JAX's gradient there is ``sigmoid(0) - y - 0.5``.
The port mirrors both (a fresh model's ReLUs closed under a zero output
bias give such logits). Held for the elementwise function, for the
registry's sigmoid key and for its callers through the registry, against
``jax.grad`` of the JAX package's losses on the same numpy inputs: rtol
1e-6, atol 1e-7 (float32, a handful of operations).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ranking_tpu.ops import loss_registry as jax_registry
from ranking_tpu.ops import losses as jax_losses
from ranking_tpu_torch.ops import loss_registry, losses

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-7)


def _port_grad(fn, logits):
  x = torch.tensor(logits, requires_grad=True)
  fn(x).backward()
  return x.grad.numpy()


def test_elementwise_gradient_at_zero_is_jax_s():
  labels = np.array([0.0, 1.0, 0.3, 0.0, 1.0], np.float32)
  logits = np.array([0.0, 0.0, 0.0, 1.5, -2.0], np.float32)
  want = jax.grad(lambda x: jnp.sum(jax_losses.sigmoid_cross_entropy(
      jnp.asarray(labels), x)))(jnp.asarray(logits))
  got = _port_grad(lambda x: torch.sum(losses.sigmoid_cross_entropy(
      torch.from_numpy(labels), x)), logits)
  np.testing.assert_allclose(got, np.asarray(want), **TOL)
  # sigmoid(0) - y - 0.5 at the three zero logits.
  np.testing.assert_allclose(got[:3], -labels[:3], **TOL)
  value = losses.sigmoid_cross_entropy(torch.from_numpy(labels),
                                       torch.from_numpy(logits)).numpy()
  np.testing.assert_allclose(value, np.asarray(
      jax_losses.sigmoid_cross_entropy(labels, logits)), **TOL)


@pytest.mark.parametrize('key, units', [
    ('sigmoid_cross_entropy_loss', None),
    ('ordinal_loss', 3),
    ('click_em_loss', 2),
])
def test_registry_gradient_at_zero_logits_is_jax_s(key, units):
  rng = np.random.RandomState(3)
  b, l = 3, 5
  labels = rng.randint(0, 3, size=(b, l)).astype(np.float32)
  if key == 'click_em_loss':
    labels = (labels > 0).astype(np.float32)
  labels[0, -1] = -1.0                      # a padded document
  shape = (b, l) if units is None else (b, l, units)
  logits = np.zeros(shape, np.float32)
  logits[1, 1] = 0.75                       # one logit off the kink
  params = {'ordinal_size': units} if key == 'ordinal_loss' else None
  jax_fn = jax_registry.make_loss_fn(key, params=params)
  port_fn = loss_registry.make_loss_fn(key, params=params)
  want = jax.grad(lambda x: jax_fn(jnp.asarray(labels), x))(
      jnp.asarray(logits))
  got = _port_grad(lambda x: port_fn(torch.from_numpy(labels), x), logits)
  np.testing.assert_allclose(got, np.asarray(want), **TOL)
  assert np.abs(got).max() > 0
