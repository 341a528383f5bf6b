"""The port's lambda weights, ranks and tie shuffle == the JAX package's.

Labels and logits come from numpy with a seed and go through both packages
with ``key=None`` / ``generator=None``. Ranks are compared exactly; item
weights and the ideal-DCG normalizer at 1e-6 (the same float32 formulas on
the same inputs; sums of a few terms); pair weights within 1e-6 of the
case's largest weight: the two frameworks' ``log1p`` differ by one ulp at
about one rank in a hundred, and ``|D(k) - D(k + 1)|`` cancels most of the
digits of ``D``, so a small weight can be off by more than 1e-6 of itself.
JAX's random numbers cannot be had
from a ``torch.Generator``, so the generator path is held to its
properties: a permutation per list, distinct scores ranked as in the
deterministic call, ties that differ between seeds, invalid items last.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ranking_tpu.ops import lambda_weights as jax_lw
from ranking_tpu.ops import sorting as jax_sorting
from ranking_tpu.utils import fns as jax_fns
from ranking_tpu.utils import list_ops as jax_list_ops
from ranking_tpu_torch.ops import lambda_weights as lw
from ranking_tpu_torch.ops import sorting
from ranking_tpu_torch.utils import fns, list_ops

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

B, L = 5, 9
TOL = dict(rtol=1e-6, atol=1e-6)


def _data(seed=0, ties=False):
  rng = np.random.RandomState(seed)
  labels = rng.randint(0, 5, (B, L)).astype(np.float32)
  labels[1] = 0.0             # no relevant item: the ideal DCG is 0
  labels[2, 6:] = -1.0        # a padded list
  labels[3] = -1.0            # an all-padding list
  if ties:
    logits = rng.randint(-2, 3, (B, L)).astype(np.float32)
  else:
    logits = (rng.randn(B, L) * 2).astype(np.float32)
  return labels, logits


def _ranks(labels, logits):
  want = jax_sorting.compute_ranks(jnp.asarray(logits),
                                   jnp.asarray(labels >= 0))
  got = sorting.compute_ranks(torch.from_numpy(logits),
                              torch.from_numpy(labels >= 0))
  return got, want


# (name, JAX weight, port weight)
def _pair_cases():
  both = lambda make: (make(jax_lw, jax_fns), make(lw, fns))  # noqa: E731
  return {
      'label_diff': both(lambda m, f: m.LabelDiffLambdaWeight()),
      'ndcg': both(lambda m, f: m.create_ndcg_lambda_weight()),
      'ndcg_top3_smooth': both(lambda m, f: m.create_ndcg_lambda_weight(
          topn=3, smooth_fraction=0.25)),
      'v1_inverse_smooth1': both(lambda m, f: m.DCGLambdaWeight(
          topn=4, gain_fn=f.pow_minus_1, rank_discount_fn=f.inverse,
          smooth_fraction=1.0)),
      'v1_defaults': both(lambda m, f: m.DCGLambdaWeight()),
      'ndcg_v2': both(lambda m, f: m.create_ndcg_lambda_weight_v2()),
      'ndcg_v2_top3': both(lambda m, f: m.create_ndcg_lambda_weight_v2(
          topn=3)),
      'v2_log2': both(lambda m, f: m.DCGLambdaWeightV2(
          topn=2, gain_fn=f.pow_minus_1, rank_discount_fn=f.log2_inverse)),
      'yeti': both(lambda m, f: m.create_yeti_dcg_lambda_weight()),
      'yeti_top4': both(lambda m, f: m.create_yeti_dcg_lambda_weight(topn=4)),
      'reciprocal_rank': both(
          lambda m, f: m.create_reciprocal_rank_lambda_weight(
              topn=5, smooth_fraction=0.5)),
      'precision': both(lambda m, f: m.PrecisionLambdaWeight(topn=3)),
  }


@pytest.mark.parametrize('ties', [False, True])
@pytest.mark.parametrize('name', sorted(_pair_cases()))
def test_pair_weights_match_jax(name, ties):
  jw, tw = _pair_cases()[name]
  labels, logits = _data(1, ties)
  got_ranks, want_ranks = _ranks(labels, logits)
  want = jw.pair_weights(jnp.asarray(labels), want_ranks)
  got = tw.pair_weights(torch.from_numpy(labels), got_ranks)
  assert got.shape == (B, L, L)
  want = np.asarray(want)
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                             atol=1e-6 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize('name', [
    'label_diff', 'ndcg', 'ndcg_top3_smooth', 'ndcg_v2', 'yeti',
    'reciprocal_rank', 'precision', 'p_list_mle'])
def test_individual_weights_match_jax(name):
  if name == 'p_list_mle':
    jw = jax_lw.create_p_list_mle_lambda_weight(L)
    tw = lw.create_p_list_mle_lambda_weight(L)
  else:
    jw, tw = _pair_cases()[name]
  labels, logits = _data(2)
  got_ranks, want_ranks = _ranks(labels, logits)
  want = jw.individual_weights(jnp.asarray(labels), want_ranks)
  got = tw.individual_weights(torch.from_numpy(labels), got_ranks)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                             atol=1e-6)


def test_lambda_weight_contracts():
  with pytest.raises(ValueError, match='smooth_fraction'):
    lw.DCGLambdaWeight(smooth_fraction=1.5)
  with pytest.raises(NotImplementedError):
    lw.ListMLELambdaWeight().pair_weights(torch.zeros(1, 2), torch.ones(1, 2))
  with pytest.raises(NotImplementedError):
    lw.LambdaWeight().pair_weights(None, None)
  # The factories use the named functions: the fused dispatcher recognizes a
  # discount by identity.
  assert lw.create_ndcg_lambda_weight().rank_discount_fn is fns.log1p_inverse
  assert lw.create_ndcg_lambda_weight_v2().gain_fn is fns.pow_minus_1
  assert (lw.create_yeti_dcg_lambda_weight().rank_discount_fn
          is fns.log2_inverse)
  hash(lw.create_ndcg_lambda_weight(topn=3))  # frozen: usable as a key


@pytest.mark.parametrize('ties', [False, True])
def test_compute_ranks_and_sorted_ranks_match_jax(ties):
  labels, logits = _data(3, ties)
  got, want = _ranks(labels, logits)
  assert got.dtype == torch.int32
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  want = jax_list_ops.sorted_ranks(jnp.asarray(logits))
  got = list_ops.sorted_ranks(torch.from_numpy(logits))
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  # Invalid items rank behind every valid one.
  valid = labels >= 0
  ranks = _ranks(labels, logits)[0].numpy()
  for b in range(B):
    if valid[b].any() and not valid[b].all():
      assert ranks[b][valid[b]].max() < ranks[b][~valid[b]].min()


@pytest.mark.parametrize('topn', [None, 3])
def test_inverse_max_dcg_and_safe_gains_match_jax(topn):
  labels, _ = _data(4)
  clean = np.where(labels >= 0, labels, 0).astype(np.float32)
  want = jax_sorting.inverse_max_dcg(jnp.asarray(clean), topn=topn)
  got = sorting.inverse_max_dcg(torch.from_numpy(clean), topn=topn)
  assert got.shape == (B, 1) and got[1].item() == 0.0
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
  want = jax_sorting.inverse_max_dcg(
      jnp.asarray(clean), gain_fn=jax_fns.identity,
      rank_discount_fn=jax_fns.log2_inverse, topn=topn)
  got = sorting.inverse_max_dcg(
      torch.from_numpy(clean), gain_fn=fns.identity,
      rank_discount_fn=fns.log2_inverse, topn=topn)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
  np.testing.assert_allclose(
      sorting.safe_gains(torch.from_numpy(clean)).numpy(),
      np.asarray(jax_sorting.safe_gains(jnp.asarray(clean))), **TOL)


def _gen(seed):
  return torch.Generator().manual_seed(seed)


def test_shuffled_ranks_are_permutations_that_respect_scores():
  rng = np.random.RandomState(5)
  scores = torch.from_numpy(rng.randint(0, 4, (6, 40)).astype(np.float32))
  plain = list_ops.sorted_ranks(scores)
  a = list_ops.sorted_ranks(scores, generator=_gen(1))
  b = list_ops.sorted_ranks(scores, generator=_gen(2))
  again = list_ops.sorted_ranks(scores, generator=_gen(1))
  assert torch.equal(a, again)        # one seed, one shuffle
  assert not torch.equal(a, b)        # ties differ between two seeds
  assert not torch.equal(a, plain)
  want = torch.arange(1, 41).expand(6, 40)
  for ranks in (a, b):
    assert torch.equal(torch.sort(ranks, dim=1).values.long(), want)
    # A higher score always ranks ahead of a lower one.
    ahead = scores[:, :, None] > scores[:, None, :]
    assert torch.all((ranks[:, :, None] < ranks[:, None, :])[ahead])
  # Distinct scores leave nothing to shuffle.
  distinct = torch.from_numpy(rng.permutation(240).reshape(6, 40)
                              .astype(np.float32))
  assert torch.equal(list_ops.sorted_ranks(distinct, generator=_gen(3)),
                     list_ops.sorted_ranks(distinct))


def test_shuffled_sort_pushes_masked_items_last():
  rng = np.random.RandomState(6)
  scores = torch.from_numpy(rng.randint(0, 3, (4, 12)).astype(np.float32))
  mask = torch.from_numpy(rng.rand(4, 12) > 0.4)
  mask[0] = False
  ids = torch.arange(12).expand(4, 12)
  got_scores, got_ids = list_ops.sort_by_scores(
      scores, [scores, ids], mask=mask, generator=_gen(7))
  top3, = list_ops.sort_by_scores(scores, [ids], topn=3, mask=mask,
                                  generator=_gen(7))
  assert torch.equal(top3, got_ids[:, :3])
  for b in range(4):
    n = int(mask[b].sum())
    assert sorted(got_ids[b].tolist()) == list(range(12))
    assert mask[b][got_ids[b][:n]].all() and not mask[b][got_ids[b][n:]].any()
    head = got_scores[b][:n]
    assert torch.all(head[:-1] >= head[1:])
  # Invalid items rank last under compute_ranks with a generator too.
  labels = torch.where(mask, 1.0, -1.0)
  ranks = sorting.compute_ranks(scores, labels >= 0, generator=_gen(8))
  for b in range(1, 4):
    assert ranks[b][mask[b]].max() < ranks[b][~mask[b]].min()
