"""The port's CUDA sort kernel on the card (skips without CUDA).

Run on a machine with the card (this file imports no JAX, so the JAX-side
conftest is left out):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from ranking_tpu_torch.ops.cuda import sort as cuda_sort
from ranking_tpu_torch.utils import list_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA card: the sort kernel has no CPU mode')
  return torch.device('cuda')


def _case(b, l, k, ties, seed):
  gen = torch.Generator().manual_seed(seed)
  scores = (torch.randint(-2, 3, (b, l), generator=gen).float() if ties
            else torch.randn(b, l, generator=gen))
  mask = torch.rand(b, l, generator=gen) > 0.3
  mask[0, : l // 2] = False
  values = torch.randn(b, l, k, generator=gen)
  return scores, mask, values


@pytest.mark.parametrize('b,l,k,topn,ties', [
    (128, 200, 2, 200, False), (128, 200, 2, 5, True), (5, 33, 1, 33, True),
    (2, 1500, 3, 64, False), (1, 1, 1, 1, False)])
def test_kernel_equals_plain_version(dev, b, l, k, topn, ties):
  scores, mask, values = (t.to(dev) for t in _case(b, l, k, ties, seed=l))
  got = cuda_sort.sorted_values_and_ranks(scores, values, mask, topn)
  want = cuda_sort.sorted_values_and_ranks_reference(scores, values, mask,
                                                     topn)
  torch.cuda.synchronize()
  assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_dispatch_sends_float_channels_to_the_kernel(dev):
  scores, mask, values = (t.to(dev) for t in _case(4, 50, 1, True, seed=1))
  labels = values[..., 0]
  ids = torch.arange(200, device=dev).reshape(4, 50) + (1 << 25)
  before = cuda_sort.sorted_values_and_ranks.launches
  got_labels, = list_ops.sort_by_scores(scores, [labels], mask=mask)
  assert cuda_sort.sorted_values_and_ranks.launches == before + 1
  got_ids, = list_ops.sort_by_scores(scores, [ids], mask=mask)
  assert cuda_sort.sorted_values_and_ranks.launches == before + 1
  order = cuda_sort.sort_order(scores, mask)
  assert torch.equal(got_labels, torch.gather(labels, 1, order))
  assert torch.equal(got_ids, torch.gather(ids, 1, order))


def test_wrapper_refuses_what_the_kernel_cannot_take(dev):
  too_long = torch.zeros(1, cuda_sort.MAX_LIST_SIZE + 1, device=dev)
  with pytest.raises(ValueError, match='shared'):
    cuda_sort.sorted_values_and_ranks(too_long, too_long[..., None])
