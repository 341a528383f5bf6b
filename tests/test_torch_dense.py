"""The encoder's dense products (``ops/cuda/dense.py``) on the CPU.

The CUDA kernel (``csrc/dense.cu``) runs only on the card
(``tests/test_torch_cuda.py``); here: the autograd function's plain path
against ``torch.tensordot`` (forward, gradients, ``gradcheck`` in float64,
with one and two contracted axes), the rule that decides which products
take the kernel, the wave model that splits their depth, and the
tensor-parallel ``DenseGeneral`` over gloo ranks through the function,
against one rank's result. No JAX.
"""

import numpy as np
import pytest
import torch

from ranking_tpu_torch.models import encoder
from ranking_tpu_torch.ops.cuda import dense
from ranking_tpu_torch.train import steps

import torch_dist_cases

# (x shape, kernel shape, contracted axes): Dense widening and narrowing
# (dW in its two orientations), the attention's query ([F, heads,
# head_dim]) and its out kernel ([heads, head_dim, F], two contracted axes).
SHAPES = [((6, 5, 8), (8, 12), 1),
          ((6, 5, 12), (12, 8), 1),
          ((3, 4, 8), (8, 2, 4), 1),
          ((3, 4, 2, 4), (2, 4, 12), 2)]


def _tensordot(x, kernel, bias, n_in):
  dims = list(range(x.ndim - n_in, x.ndim))
  y = torch.tensordot(x, kernel, dims=(dims, list(range(n_in))))
  return y if bias is None else y + bias


def _inputs(x_shape, k_shape, n_in, dtype, seed=0):
  gen = torch.Generator().manual_seed(seed)
  x = torch.randn(x_shape, generator=gen, dtype=dtype)
  kernel = torch.randn(k_shape, generator=gen, dtype=dtype)
  bias = torch.randn(k_shape[n_in:], generator=gen, dtype=dtype)
  return x, kernel, bias


@pytest.mark.parametrize('with_bias', [True, False])
@pytest.mark.parametrize('x_shape,k_shape,n_in', SHAPES)
def test_plain_function_equals_tensordot(x_shape, k_shape, n_in, with_bias):
  x, kernel, bias = _inputs(x_shape, k_shape, n_in, torch.float32)
  bias = bias if with_bias else None
  leaves = [t.clone().requires_grad_() for t in (x, kernel)]
  want_leaves = [t.clone().requires_grad_() for t in (x, kernel)]
  b, want_b = ((bias.clone().requires_grad_(), bias.clone().requires_grad_())
               if with_bias else (None, None))
  got = dense.dense_general(*leaves, b, n_in)
  want = _tensordot(*want_leaves, want_b, n_in)
  assert got.shape == want.shape
  torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
  cot = torch.randn(want.shape, generator=torch.Generator().manual_seed(1))
  (got * cot).sum().backward()
  (want * cot).sum().backward()
  for g, w in zip(leaves + [b], want_leaves + [want_b]):
    if w is not None:
      torch.testing.assert_close(g.grad, w.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('x_shape,k_shape,n_in', SHAPES)
def test_plain_function_gradcheck_float64(x_shape, k_shape, n_in):
  x, kernel, bias = (t.requires_grad_() for t in _inputs(
      x_shape, k_shape, n_in, torch.float64, seed=2))
  assert torch.autograd.gradcheck(
      lambda x, k, b: dense.dense_general(x, k, b, n_in), (x, kernel, bias))


@pytest.mark.parametrize('device,dtype,m,k,n,taken', [
    ('cuda', torch.float32, 4096, 768, 768, True),      # Q, K, V, out
    ('cuda', torch.float32, 4096, 768, 3072, True),     # Dense_0
    ('cuda', torch.float32, 4096, 3072, 768, True),     # Dense_1
    ('cuda', torch.float32, 16384, 768, 768, True),     # serving
    ('cuda', torch.bfloat16, 4096, 768, 768, False),    # already on the cores
    ('cuda', torch.float32, 4096, 768, 1, False),       # the score head
    ('cuda', torch.float32, 32, 768, 768, False),       # the pooler
    ('cuda', torch.float32, 3200, 100, 100, False),     # DIN: small
    ('cuda', torch.float32, 1024, 768, 768, False),     # 2^29.2 MACs
    ('cuda', torch.float32, 2048, 768, 768, True),      # 2^30.2 MACs
    ('cuda', torch.float32, 64, 4096, 4096, False),     # half a tile
    ('cuda', torch.float32, 4096, 766, 768, False),     # 16-byte strides
    ('cuda', torch.float32, 4096, 768, 770, False),
    ('cpu', torch.float32, 4096, 768, 768, False),
])
def test_routing_rule(device, dtype, m, k, n, taken):
  assert dense.takes(device, dtype, m, k, n) is taken


@pytest.mark.parametrize('m,n,k', [
    (4096, 768, 768), (4096, 3072, 768), (4096, 768, 3072),
    (768, 768, 4096), (768, 3072, 4096), (3072, 768, 4096),
    (16384, 768, 768), (16384, 3072, 768), (256, 768, 768), (300, 8, 36)])
def test_wave_plan(m, n, k):
  """Each plan is one the kernel takes and fills no more blocks than it has
  units; the train shapes' forward products take one wave of tiles
  unsplit, and dW's few tiles deep 4,096 split their depth."""
  splits, grid = dense.plan(m, n, k, 132)
  units = -(-m // dense.TILE_M) * -(-n // dense.TILE_N) * splits
  slices = -(-k // dense.SLICE)
  assert 1 <= splits <= slices
  assert 1 <= grid <= min(units, 132)
  if m == 4096:
    assert splits == 1
    if n == 768:
      assert units <= 132
  if k == 4096:
    assert splits > 1


@pytest.mark.parametrize('rows,k,n', [(7, 12, 8), (7, 8, 12)])
def test_backward_products_in_each_orientation(rows, k, n):
  """dx and dW as the card computes them, orientation for orientation: dW
  = x^T dy where dy is the narrower (n <= k), else dW^T = dy^T x written
  transposed; both against the plain products."""
  gen = torch.Generator().manual_seed(5)
  x = torch.randn(rows, k, generator=gen, dtype=torch.float64)
  w = torch.randn(k, n, generator=gen, dtype=torch.float64)
  dy = torch.randn(rows, n, generator=gen, dtype=torch.float64)
  torch.testing.assert_close(dense._weight_grad(x, dy), x.t() @ dy)
  torch.testing.assert_close(dense._input_grad(dy, w), dy @ w.t())
  torch.testing.assert_close(dense._forward(x, w, None),
                             dense.dense_reference(x, w, None))


def test_dense_general_takes_the_function_where_the_rule_says(monkeypatch):
  """A transformer block with the rule forced on (its products through the
  function's plain path) equals the block through ``tensordot``."""
  gen = torch.Generator().manual_seed(3)
  block = encoder.TransformerBlock(16, 4, 32, dropout=0.0, generator=gen)
  x = torch.randn(3, 5, 16, generator=gen)
  mask = torch.rand(3, 5, generator=gen) > 0.2
  want = block(x, mask)
  calls = []
  general = dense.dense_general
  monkeypatch.setattr(dense, 'takes', lambda *args: True)
  monkeypatch.setattr(dense, 'dense_general',
                      lambda *a: calls.append(1) or general(*a))
  got = block(x, mask)
  assert len(calls) == 6           # query, key, value, out, Dense_0, Dense_1
  torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_launch_counts_include_the_kernel():
  assert 'dense_gemm' in steps.kernel_launch_counts()
  assert dense.dense_gemm.launches == 0   # no card here: nothing launched


@pytest.fixture(scope='module')
def tp_ranks(tmp_path_factory):
  config = dict(hidden_dim=16, num_heads=4, mlp_dim=32)
  gen = torch.Generator().manual_seed(4)
  model = torch.nn.Module()
  model.block_0 = encoder.TransformerBlock(**config, dropout=0.0,
                                           generator=gen)
  rng = np.random.RandomState(4)
  inp = {'config': config,
         'state': {k: v.numpy() for k, v in model.state_dict().items()},
         'x': rng.randn(3, 5, 16).astype(np.float32),
         'mask': rng.rand(3, 5) > 0.2,
         'cot': rng.randn(3, 5, 16).astype(np.float32)}
  runs = {2: (str(tmp_path_factory.mktemp('dense_tp')),
              {'dense_tp': ((1, 2), inp)})}
  started = torch_dist_cases.start(runs)
  x = torch.from_numpy(inp['x']).requires_grad_()
  y = model.block_0(x, torch.from_numpy(inp['mask']))
  (y * torch.from_numpy(inp['cot'])).sum().backward()
  one = {'y': y.detach().numpy(), 'dx': x.grad.numpy(),
         'grads': {k: p.grad.numpy() for k, p in model.named_parameters()}}
  return one, [r['dense_tp'] for r in torch_dist_cases.join(started)[2]]


@pytest.mark.parametrize('rank', [0, 1])
def test_tensor_parallel_dense_general_equals_one_rank(tp_ranks, rank):
  """Model group of 2 over gloo: the heads and the MLP split as
  ENCODER_TP_RULES says, the copy and reduce roles around the function's
  local product; output, input gradient and whole parameter gradients as
  one rank's block computes them."""
  one, per_rank = tp_ranks
  got = per_rank[rank]
  assert 'error' not in got, got.get('error')
  assert got['calls'] == 6
  assert 'block_0.Dense_1.kernel' in got['sharded']
  assert 'block_0.MultiHeadDotProductAttention_0.out.kernel' in got['sharded']
  np.testing.assert_allclose(got['y'], one['y'], rtol=1e-5, atol=1e-5)
  np.testing.assert_allclose(got['dx'], one['dx'], rtol=1e-5, atol=1e-5)
  assert sorted(got['grads']) == sorted(one['grads'])
  for k, want in one['grads'].items():
    np.testing.assert_allclose(got['grads'][k], want, rtol=1e-5, atol=1e-5,
                               err_msg=k)
