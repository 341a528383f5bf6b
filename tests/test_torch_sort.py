"""PyTorch port's per-list sort == the JAX package's, exactly.

The port's plain version (``sorted_values_and_ranks_reference``) is held
against the Pallas kernel run in interpret mode, and the port's
``list_ops.sort_by_scores`` / ``sorted_ranks`` against the JAX package's
default XLA path. Ranks must be equal; sorted values must be equal (over
the valid prefix where the XLA path orders the invalid tail differently).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ranking_tpu.ops.pallas import sort as psort
from ranking_tpu.utils import list_ops as jax_list_ops
from ranking_tpu_torch.ops.cuda import sort as torch_sort
from ranking_tpu_torch.utils import list_ops

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)


@pytest.fixture
def interpret():
  prev = psort._INTERPRET
  psort._INTERPRET = True
  yield
  psort._INTERPRET = prev


def _case(b, l, k, kind='random', seed=0):
  """Scores, mask and values made with numpy from a seed."""
  rng = np.random.RandomState(seed)
  if kind == 'ties':
    scores = rng.randint(-3, 4, size=(b, l)).astype(np.float32)
  else:
    scores = rng.randn(b, l).astype(np.float32)
  mask = rng.rand(b, l) > 0.3
  if kind == 'special':
    mask[0] = False                      # an all-invalid row
    scores[1, :5] = -np.inf              # valid -inf scores in row 1
    mask[1, :3] = True
  values = rng.randn(b, l, k).astype(np.float32)
  return scores, mask, values


# The cases chip_smoke.py holds the CUDA kernel to, at the same shapes
# except the top of the kernel's list-size domain (below).
CASES = {
    'flagship_top1': (128, 200, 2, 1, 'random'),
    'flagship_top5': (128, 200, 2, 5, 'random'),
    'flagship_top10': (128, 200, 2, 10, 'random'),
    'flagship_full': (128, 200, 2, 200, 'random'),
    'ties': (128, 200, 2, 200, 'ties'),
    'all_invalid_and_neg_inf': (4, 200, 2, 200, 'special'),
    'list_size_37': (3, 37, 3, 10, 'random'),
    'batch_1': (1, 200, 2, 200, 'random'),
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_reference_matches_pallas_kernel(name, interpret):
  b, l, k, topn, kind = CASES[name]
  scores, mask, values = _case(b, l, k, kind)
  want_sorted, want_ranks = psort.sorted_values_and_ranks(
      jnp.asarray(scores), jnp.asarray(values), jnp.asarray(mask), topn)
  got_sorted, got_ranks = torch_sort.sorted_values_and_ranks(
      torch.from_numpy(scores), torch.from_numpy(values),
      torch.from_numpy(mask), topn)
  np.testing.assert_array_equal(got_ranks.numpy(), np.asarray(want_ranks))
  np.testing.assert_array_equal(got_sorted.numpy(), np.asarray(want_sorted))


def _assert_valid_prefix_equal(got, want, mask, topn):
  n_valid = np.minimum(mask.sum(axis=1), topn)
  for row in range(mask.shape[0]):
    np.testing.assert_array_equal(got[row, :n_valid[row]],
                                  want[row, :n_valid[row]])


@pytest.mark.parametrize('name', ['flagship_top5', 'ties',
                                  'all_invalid_and_neg_inf', 'batch_1'])
def test_sort_by_scores_matches_xla_path(name):
  b, l, k, topn, kind = CASES[name]
  scores, mask, values = _case(b, l, k, kind)
  labels, weights = values[..., 0], values[..., 1]
  ids = np.arange(b * l, dtype=np.int32).reshape(b, l) + (1 << 25)
  want = jax_list_ops.sort_by_scores(
      jnp.asarray(scores), [jnp.asarray(labels), jnp.asarray(weights),
                            jnp.asarray(ids)],
      topn=topn, mask=jnp.asarray(mask))
  got = list_ops.sort_by_scores(
      torch.from_numpy(scores), [torch.from_numpy(labels),
                                 torch.from_numpy(weights),
                                 torch.from_numpy(ids)],
      topn=topn, mask=torch.from_numpy(mask))
  assert got[2].dtype == torch.int32  # integer channels stay exact
  for g, w in zip(got, want):
    _assert_valid_prefix_equal(g.numpy(), np.asarray(w), mask, topn)


def test_sort_by_scores_at_top_of_kernel_domain():
  l = torch_sort.MAX_LIST_SIZE
  scores, mask, values = _case(1, l, 1, seed=3)
  labels = values[..., 0]
  want, = jax_list_ops.sort_by_scores(jnp.asarray(scores),
                                      [jnp.asarray(labels)],
                                      mask=jnp.asarray(mask))
  got, = list_ops.sort_by_scores(torch.from_numpy(scores),
                                 [torch.from_numpy(labels)],
                                 mask=torch.from_numpy(mask))
  _assert_valid_prefix_equal(got.numpy(), np.asarray(want), mask, l)


@pytest.mark.parametrize('kind', ['random', 'ties'])
def test_sorted_ranks_matches_xla_path(kind):
  scores, _, _ = _case(16, 37, 1, kind, seed=5)
  want = jax_list_ops.sorted_ranks(jnp.asarray(scores))
  got = list_ops.sorted_ranks(torch.from_numpy(scores))
  assert got.dtype == torch.int32
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_shared_scope_serves_topn_slices_of_one_sort():
  scores, mask, values = _case(8, 50, 2, 'ties', seed=7)
  s, m = torch.from_numpy(scores), torch.from_numpy(mask)
  labels = torch.from_numpy(values[..., 0])
  want = [list_ops.sort_by_scores(s, [labels], topn=n, mask=m)[0]
          for n in (1, 5, None)]
  with list_ops.shared_sort_scope():
    got = [list_ops.sort_by_scores(s, [labels], topn=n, mask=m)[0]
           for n in (1, 5, None)]
    assert len(list_ops.shared_sort_cache()) == 1
  assert list_ops.shared_sort_cache() is None
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_cpu_wrapper_never_launches_the_kernel():
  scores, mask, values = _case(2, 9, 1)
  before = torch_sort.sorted_values_and_ranks.launches
  torch_sort.sorted_values_and_ranks(torch.from_numpy(scores),
                                     torch.from_numpy(values),
                                     torch.from_numpy(mask))
  assert torch_sort.sorted_values_and_ranks.launches == before


def _packed_keys(scores, mask):
  """The CUDA kernel's key (csrc/sort.cu) as int64: bits 47..16 the
  order-preserving bits of the filled score (-0.0 folded into +0.0), bit
  15 validity, bits 14..0 the position's complement to 32767."""
  s = torch.from_numpy(scores)
  valid = torch.from_numpy(mask)
  inf = torch.full_like(s, float('inf'))
  row_min = torch.amin(torch.where(valid, s, inf), dim=1, keepdim=True)
  row_min = torch.where(row_min == float('inf'), 0.0, row_min)
  filled = torch.where(valid, s, row_min)
  filled = torch.where(filled == 0, 0.0, filled)
  bits = filled.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
  ordered = torch.where(bits >= 1 << 31, bits ^ 0xFFFFFFFF, bits | 1 << 31)
  pos = torch.arange(s.shape[1], dtype=torch.int64)
  return (ordered << 16) | (valid.to(torch.int64) << 15) | (32767 - pos)


def _edge_case(l):
  """Score ties, +0.0 beside -0.0, -inf scores, an all-invalid row."""
  scores, mask, values = _case(6, l, 2, 'ties', seed=l)
  scores[:, ::3] = 0.0
  scores[:, 1::3] = np.where(scores[:, 1::3] == 0, -0.0, scores[:, 1::3])
  scores[2, ::2] = -0.0
  scores[3, : max(1, l // 4)] = -np.inf
  mask[0] = False
  mask[4] = True
  return scores, mask, values


@pytest.mark.parametrize('l', [1, 33, 257])
def test_packed_key_order_is_the_kernel_order(l, interpret):
  scores, mask, values = _edge_case(l)
  keys = _packed_keys(scores, mask)
  assert torch.unique(keys[1]).numel() == l        # one key an item
  # rank_i = 1 + #{j : key_j > key_i}, as the kernel counts it.
  ranks = 1 + (keys[:, None, :] > keys[:, :, None]).sum(dim=2)
  order = torch.sort(keys, dim=1, descending=True).indices
  np.testing.assert_array_equal(
      order.numpy(),
      torch_sort.sort_order(torch.from_numpy(scores),
                            torch.from_numpy(mask)).numpy())
  _, want_ranks = psort.sorted_values_and_ranks(
      jnp.asarray(scores), jnp.asarray(values), jnp.asarray(mask), l)
  np.testing.assert_array_equal(ranks.numpy().astype(np.float32),
                                np.asarray(want_ranks))
  positions = torch.empty_like(ranks)
  positions.scatter_(1, order, torch.arange(1, l + 1).expand(6, l))
  assert torch.equal(positions, ranks)
