"""The port's CUDA kernels on the card (skips without CUDA).

Run on a machine with the card (this file imports no JAX, so the JAX-side
conftest is left out):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from ranking_tpu_torch.models import encoder
from ranking_tpu_torch.ops import lambda_weights as lw
from ranking_tpu_torch.ops import losses
from ranking_tpu_torch.ops.cuda import dense
from ranking_tpu_torch.ops.cuda import fused_bn
from ranking_tpu_torch.ops.cuda import pairwise
from ranking_tpu_torch.ops.cuda import rows
from ranking_tpu_torch.ops.cuda import sort as cuda_sort
from ranking_tpu_torch.train import sparse
from ranking_tpu_torch.utils import list_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA card: the kernels have no CPU mode')
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


@pytest.mark.parametrize('l', [1, 31, 32, 33, 257])
@pytest.mark.parametrize('k', [1, 3])
def test_kernel_equals_plain_version_at_key_edges(dev, l, k):
  """Each count of threads an item, a warp's width and one off it, the
  key chunks' padding; -0.0 beside +0.0, -inf scores, an all-invalid row;
  topn 1 and L."""
  scores, mask, values = _case(5, l, k, True, seed=l + k)
  scores[:, ::2] = torch.where(scores[:, ::2] == 0, -0.0, scores[:, ::2])
  scores[1, :5] = -float('inf')
  mask[2] = False
  scores, mask, values = (t.to(dev) for t in (scores, mask, values))
  for topn in sorted({1, l}):
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


# --- the fused masked-BN tower (rows 2-6 of the kernel table) ---------------

# Share of the largest value of an output: float32 sums in another order;
# bf16 stores may differ by one ulp (2^-8, rounded up to 2^-7).
_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -7, 2e-3)}


def _tower_case(dev, n, dims, act, seed):
  gen = torch.Generator().manual_seed(seed)
  rnd = lambda *shape, scale=1.0: (  # noqa: E731
      torch.randn(*shape, generator=gen) * scale).to(dev)
  x = rnd(n, dims[0])
  mask = (torch.rand(n, generator=gen) > 0.3).float().to(dev)
  weights = [rnd(o, i, scale=i ** -0.5) for i, o in zip(dims[:-1], dims[1:])]
  vecs = [[rnd(o, scale=.1) for o in dims[1:]],
          [1 + rnd(o, scale=.1) for o in dims[1:]],
          [rnd(o, scale=.1) for o in dims[1:]]]
  return x, mask, weights, vecs, rnd(n, dims[-1]).to(act)


def _assert_close(got, want, tol):
  got, want = got.float(), want.float()
  assert got.shape == want.shape
  assert (got - want).abs().max() <= tol * want.abs().max().clamp(min=1e-30)


@pytest.mark.parametrize('act', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('n,dims', [(700, (136, 96, 40)),
                                    (1000, (20, 130, 129))])
def test_fused_bn_rows_equal_plain_versions(dev, n, dims, act):
  x, mask, (w0, w1), (bs, gammas, betas), g = _tower_case(dev, n, dims, act,
                                                           seed=n)
  stored, summed = _TOL[act]
  ones, zeros = torch.ones(dims[0], device=dev), torch.zeros(dims[0],
                                                             device=dev)
  s0, t0, s1, t1 = gammas[0], betas[0], gammas[1], betas[1]
  c1, c2 = 0.01 * bs[1], 0.01 * betas[1]

  def both(fn):
    got = fn()
    with fused_bn.plain_versions():
      want = fn()
    torch.cuda.synchronize()
    return got, want

  got, want = both(lambda: fused_bn.layer_forward(
      x, mask, ones, zeros, w0.t(), bs[0], relu_in=False, act_dtype=act))
  y0 = want[0]
  for g_i, w_i, tol in zip(got, want, (stored, summed, summed)):
    _assert_close(g_i, w_i, tol)
  got, want = both(lambda: fused_bn.layer_forward(
      y0, mask, s0, t0, w1.t(), bs[1], relu_in=True, act_dtype=act))
  y1 = want[0]
  for g_i, w_i, tol in zip(got, want, (stored, summed, summed)):
    _assert_close(g_i, w_i, tol)
  got, want = both(lambda: fused_bn.bwd_stats(g, y1, s1, t1))
  for g_i, w_i in zip(got, want):
    _assert_close(g_i, w_i, summed)
  for kw in (dict(), dict(x0=x), dict(x0=x, emit_dx=False)):
    got, want = both(lambda: fused_bn.bwd_mats(
        g, y1, mask, s1, t1, c1, c2, y0, s0, t0, w1.t(), relu_in=True,
        emit_prev_stats=True, **kw))
    assert len(got) == len(want) == (6 if kw else 4)
    for i, (g_i, w_i) in enumerate(zip(got, want)):
      assert (g_i is None) == (w_i is None)
      if g_i is not None:
        _assert_close(g_i, w_i, stored if i == 0 else summed)
  g0 = want[0] if want[0] is not None else torch.zeros_like(y0)
  k1, k2 = 0.01 * bs[0], 0.01 * betas[0]
  got, want = both(lambda: fused_bn.bwd_dx_only(g0, y0, mask, s0, t0, k1, k2,
                                                w0.t()))
  _assert_close(got, want, summed)
  got, want = both(lambda: fused_bn.bwd_dw_only(
      g0, y0, mask, s0, t0, k1, k2, x, ones, zeros, relu_in=False))
  _assert_close(got, want, summed)


@pytest.mark.parametrize('act', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('w_layout', ['parameter view', 'contiguous'])
@pytest.mark.parametrize('n,dims', [(700, (136, 264, 8)),
                                    (25601, (136, 8, 264)),
                                    (700, (129, 130, 136))])
def test_fused_bn_tile_edges_equal_plain_versions_and_repeat(dev, n, dims,
                                                             w_layout, act):
  """N off the 128-row tile, F_0 = 136, outputs of 8 and 264 columns,
  unaligned widths, W as the parameter's transposed view or contiguous:
  every function within the tolerances of its plain version, and two calls
  on the same inputs bitwise equal."""
  x, mask, (w0, w1), (bs, gammas, betas), g = _tower_case(dev, n, dims, act,
                                                           seed=n + dims[1])
  stored, summed = _TOL[act]
  as_w = ((lambda w: w.t()) if w_layout == 'parameter view'
          else (lambda w: w.t().contiguous()))
  ones, zeros = torch.ones(dims[0], device=dev), torch.zeros(dims[0],
                                                             device=dev)
  s0, t0, s1, t1 = gammas[0], betas[0], gammas[1], betas[1]
  c1, c2 = 0.01 * bs[1], 0.01 * betas[1]

  def check(fn, tols):
    got, again = fn(), fn()
    with fused_bn.plain_versions():
      want = fn()
    torch.cuda.synchronize()
    got, again, want = ((o,) if isinstance(o, torch.Tensor) else o
                        for o in (got, again, want))
    for g_i, a_i, w_i, tol in zip(got, again, want, tols):
      assert (g_i is None) == (w_i is None)
      if g_i is not None:
        assert torch.equal(g_i, a_i)
        _assert_close(g_i, w_i, tol)
    return want

  y0 = check(lambda: fused_bn.layer_forward(
      x, mask, ones, zeros, as_w(w0), bs[0], relu_in=False, act_dtype=act),
             (stored, summed, summed))[0]
  y1 = check(lambda: fused_bn.layer_forward(
      y0, mask, s0, t0, as_w(w1), bs[1], relu_in=True, act_dtype=act),
             (stored, summed, summed))[0]
  check(lambda: fused_bn.bwd_stats(g, y1, s1, t1), (summed, summed))
  for kw in (dict(), dict(x0=x, emit_dx=False)):
    check(lambda: fused_bn.bwd_mats(
        g, y1, mask, s1, t1, c1, c2, y0, s0, t0, as_w(w1), relu_in=True,
        emit_prev_stats=True, **kw), (stored,) + (summed,) * 5)
  g0 = torch.randn(y0.shape, generator=torch.Generator().manual_seed(n)).to(
      dev, act)
  k1, k2 = 0.01 * bs[0], 0.01 * betas[0]
  check(lambda: fused_bn.bwd_dx_only(g0, y0, mask, s0, t0, k1, k2,
                                     as_w(w0)), (summed,))
  check(lambda: fused_bn.bwd_dw_only(g0, y0, mask, s0, t0, k1, k2, x, ones,
                                     zeros, relu_in=False), (summed,))


@pytest.mark.parametrize('dims,input_grad,counts', [
    ((136, 96, 40, 24), False, [3, 1, 2, 0, 0]),
    ((136, 96, 40), True, [2, 1, 1, 1, 0]),
    ((136, 96), True, [1, 1, 0, 1, 1]),
    ((136, 96), False, [1, 1, 0, 0, 1])])
def test_fused_op_launches_and_gradients(dev, dims, input_grad, counts):
  x, mask, weights, vecs, cot = _tower_case(dev, 900, dims, torch.float32, 3)

  def run():
    xd = x.clone().requires_grad_(input_grad)
    leaves = [[p.clone().requires_grad_() for p in group]
              for group in [weights] + vecs]
    out, means, vars_ = fused_bn.fused_bn_mlp(xd, mask, *leaves,
                                              input_grad=input_grad)
    flat = ([xd] if input_grad else []) + [p for grp in leaves for p in grp]
    return [out, *means, *vars_,
            *torch.autograd.grad((out * cot).sum(), flat)]

  fused_bn.reset_launches()
  got = run()
  assert [fn.launches for fn in fused_bn.KERNEL_WRAPPERS] == counts
  with fused_bn.plain_versions():
    want = run()
  assert [fn.launches for fn in fused_bn.KERNEL_WRAPPERS] == counts
  for g_i, w_i in zip(got, want):
    if w_i.abs().max() > 1e-3:  # bias gradients are rounding noise around 0
      _assert_close(g_i, w_i, 1e-4)


def test_fused_wrappers_refuse_what_the_kernels_cannot_take(dev):
  x = torch.zeros(8, 4, device=dev)
  with pytest.raises(ValueError, match='float32 or bfloat16'):
    fused_bn.layer_forward(x.half(), torch.ones(8, device=dev),
                           torch.ones(4, device=dev),
                           torch.zeros(4, device=dev),
                           torch.zeros(4, 2, device=dev),
                           torch.zeros(2, device=dev), relu_in=False)
  with pytest.raises(ValueError, match='w:'):
    fused_bn.layer_forward(x, torch.ones(8, device=dev),
                           torch.ones(4, device=dev),
                           torch.zeros(4, device=dev),
                           torch.zeros(5, 2, device=dev),
                           torch.zeros(2, device=dev), relu_in=False)


# --- the fused pairwise sums (rows 7 and 8 of the kernel table) -------------


def _pairwise_case(dev, b, l, seed):
  gen = torch.Generator().manual_seed(seed)
  labels = torch.randint(0, 5, (b, l), generator=gen).float()
  valid = torch.rand(b, l, generator=gen) > 0.2
  labels = torch.where(valid, labels, -1.0)
  logits = torch.randn(b, l, generator=gen) * 2
  weights = torch.where(valid, torch.rand(b, l, generator=gen) + 0.1, 0.0)
  gain = torch.pow(2.0, labels.clamp(min=0)) - 1.0
  ranks = torch.argsort(torch.rand(b, l, generator=gen), dim=1).float() + 1.0
  scale = torch.rand(b, generator=gen) * 2 + 0.5
  ct = torch.randn(b, 3, generator=gen)
  return [t.to(dev) for t in (labels, logits, valid.float(), weights, gain,
                              ranks, scale, ct)]


@pytest.mark.parametrize('b,l', [(128, 200), (5, 11), (3, 1), (2, 1030),
                                 (128, 33), (128, 199), (128, 201), (1, 1)])
@pytest.mark.parametrize('lambda_mode', range(5))
@pytest.mark.parametrize('loss_type', range(3))
def test_pairwise_rows_equal_plain_versions(dev, loss_type, lambda_mode, b, l):
  *ops, ct = _pairwise_case(dev, b, l, seed=l + lambda_mode)
  static = (loss_type, lambda_mode, pairwise.DISCOUNT_LOG1P_INVERSE, 10.0,
            0.25 if lambda_mode == pairwise.LAMBDA_DCG_V1 else 0.0)
  got = pairwise.pairwise_sums_forward(*ops, *static)
  got_grad = pairwise.pairwise_sums_backward(*ops, *static, ct)
  with pairwise.plain_versions():
    want = pairwise.pairwise_sums_forward(*ops, *static)
    want_grad = pairwise.pairwise_sums_backward(*ops, *static, ct)
  torch.cuda.synchronize()
  assert torch.equal(got[:, 2], want[:, 2])   # the count: exact
  _assert_close(got[:, :2], want[:, :2], 1e-5)
  _assert_close(got_grad, want_grad, 1e-5)


@pytest.mark.parametrize('lambda_mode', [pairwise.LAMBDA_DCG_V2,
                                         pairwise.LAMBDA_DCG_V1,
                                         pairwise.LAMBDA_DCG_V2_NEIGHBOR])
def test_pairwise_rows_take_any_ranks(dev, lambda_mode):
  """Ranks that are not whole numbers in [1, L] (halves in some lists, a
  rank above L in others) send those lists to the per-pair formula; the
  other lists keep the discount tables."""
  *ops, ct = _pairwise_case(dev, 12, 200, seed=lambda_mode)
  ranks = ops[5]
  ranks[0::3, :: 7] += 0.5
  ranks[1::3, 3] = 203.0
  static = (pairwise.LOSS_LOGISTIC, lambda_mode,
            pairwise.DISCOUNT_LOG2_INVERSE, 10.0, 0.25)
  got = pairwise.pairwise_sums_forward(*ops, *static)
  got_grad = pairwise.pairwise_sums_backward(*ops, *static, ct)
  with pairwise.plain_versions():
    want = pairwise.pairwise_sums_forward(*ops, *static)
    want_grad = pairwise.pairwise_sums_backward(*ops, *static, ct)
  torch.cuda.synchronize()
  assert torch.equal(got[:, 2], want[:, 2])
  _assert_close(got[:, :2], want[:, :2], 1e-5)
  _assert_close(got_grad, want_grad, 1e-5)


def test_pairwise_loss_launches_and_matches_the_plain_path(dev):
  labels, logits, _, weights, *_ = _pairwise_case(dev, 16, 300, seed=5)
  loss = losses.PairwiseLogisticLoss(
      lambda_weight=lw.create_ndcg_lambda_weight())

  def run():
    s = logits.clone().requires_grad_()
    value = loss(labels, s, weights=weights)
    value.backward()
    return value.detach(), s.grad

  pairwise.reset_launches()
  got = run()
  assert [fn.launches for fn in pairwise.KERNEL_WRAPPERS] == [1, 1]
  pairwise.set_enabled(False)
  try:
    want = run()
  finally:
    pairwise.set_enabled(None)
  assert [fn.launches for fn in pairwise.KERNEL_WRAPPERS] == [1, 1]
  torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
  _assert_close(got[1], want[1], 1e-5)


def test_pairwise_wrappers_refuse_what_the_kernels_cannot_take(dev):
  too_long = torch.zeros(1, pairwise.MAX_LIST_SIZE + 1, device=dev)
  assert pairwise.enabled(too_long)   # the default on the card: the kernels
  with pytest.raises(ValueError, match='shared memory'):
    losses.PairwiseHingeLoss()(too_long, too_long)
  pairwise.set_enabled(False)         # the plain path only when asked for
  try:
    value = losses.PairwiseHingeLoss()(too_long[:, :64], too_long[:, :64])
  finally:
    pairwise.set_enabled(None)
  assert value.item() == 0.0


# --- the row scatter (rows 9-10 of the kernel table) -------------------------


def _rows_case(dev, v, d, k, n, dtype, seed):
  """n tables [V, D] and slabs [K, D]; unique ids among valid slots, with
  invalid slots, a negative id and ids >= V among them."""
  gen = torch.Generator().manual_seed(seed)
  tables = [torch.randn(v, d, generator=gen).to(dev, dtype) for _ in range(n)]
  updates = [torch.randn(k, d, generator=gen).to(dev, dtype)
             for _ in range(n)]
  ids = torch.randperm(v, generator=gen)[:k].to(torch.int32)
  valid = torch.rand(k, generator=gen) > 0.2
  if k >= 3:
    ids[0], ids[1] = -1, v + 7
  return tables, updates, ids.to(dev), valid.to(dev)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('n', [1, 2, 3])
@pytest.mark.parametrize('v,d,k', [(5000, 128, 4099), (700, 20, 333),
                                   (700, 64, 1), (300, 8, 300)])
def test_rows_kernel_equals_plain_version(dev, v, d, k, n, dtype):
  tables, updates, ids, valid = _rows_case(dev, v, d, k, n, dtype, seed=k + n)
  want = [t.clone() for t in tables]
  with rows.plain_versions():
    rows.scatter_rows_multi(want, ids, valid, updates)
  rows.reset_launches()
  got = rows.scatter_rows_multi(tables, ids, valid, updates)
  torch.cuda.synchronize()
  assert [fn.launches for fn in rows.KERNEL_WRAPPERS] == (
      [1, 0] if n == 1 else [0, 1])
  for g, w, t in zip(got, want, tables):
    assert g is t and torch.equal(g, w)


def test_rows_kernel_skips_every_invalid_slot(dev):
  tables, updates, ids, valid = _rows_case(dev, 1000, 128, 500, 2,
                                           torch.float32, seed=1)
  before = [t.clone() for t in tables]
  rows.scatter_rows_multi(tables, ids, torch.zeros_like(valid), updates)
  torch.cuda.synchronize()
  assert all(torch.equal(t, b) for t, b in zip(tables, before))


def test_rows_wrappers_refuse_what_the_kernel_cannot_take(dev):
  t = torch.zeros(10, 4, device=dev)
  ids = torch.arange(3, device=dev)
  ok = torch.ones(3, dtype=torch.bool, device=dev)
  with pytest.raises(ValueError, match='updates must be'):
    rows.scatter_rows(t, ids, ok, torch.zeros(3, 4, device=dev,
                                              dtype=torch.bfloat16))
  with pytest.raises(ValueError, match='contiguous'):
    rows.scatter_rows(torch.zeros(4, 10, device=dev).t(), ids, ok,
                      torch.zeros(3, 4, device=dev))
  with pytest.raises(ValueError, match='2- and 4-byte'):
    rows.scatter_rows(t.double(), ids, ok, torch.zeros(3, 4, device=dev,
                                                        dtype=torch.float64))
  with pytest.raises(ValueError, match='at most 3'):
    rows.scatter_rows_multi([t] * 4, ids, ok, [torch.zeros(3, 4, device=dev)] * 4)


@pytest.mark.parametrize('n', [1, 3])
def test_rows_kernel_drops_int64_ids_beyond_int32(dev, n):
  """int64 ids reach the kernel as they are: 2^32 + 5 must not wrap into
  row 5."""
  tables, updates, ids, valid = _rows_case(dev, 1000, 128, 6, n,
                                           torch.float32, seed=2)
  ids = ids.to(torch.int64)
  ids[2:5] = torch.tensor([2 ** 32 + 5, 2 ** 31, -(2 ** 32) + 9])
  valid[:] = True
  want = [t.clone() for t in tables]
  with rows.plain_versions():
    rows.scatter_rows_multi(want, ids, valid, updates)
  rows.reset_launches()
  rows.scatter_rows_multi(tables, ids, valid, updates)
  torch.cuda.synchronize()
  assert sum(fn.launches for fn in rows.KERNEL_WRAPPERS) == 1
  assert all(torch.equal(g, w) for g, w in zip(tables, want))


@pytest.mark.parametrize('kind', ['adam', 'adagrad'])
def test_update_rows_of_a_3d_table_launch_the_kernel(dev, kind):
  """A [V, a, b] table goes through the kernel as a [V, a*b] view, one
  launch, bitwise equal to the plain scatter."""
  gen = torch.Generator().manual_seed(3)
  spec = sparse.LazyAdam(1e-2) if kind == 'adam' else sparse.LazyAdagrad(1e-2)
  table = torch.randn(500, 4, 5, generator=gen).to(dev)
  uids = torch.randperm(500, generator=gen)[:64].to(dev, torch.int32)
  g = torch.randn(64, 4, 5, generator=gen).to(dev)
  g[7] = 0.0
  filled = (torch.arange(64) < 50).to(dev)
  results = []
  for plain in (False, True):
    tables = {'t': table.clone()}
    state = spec.init(tables)
    rows.reset_launches()
    if plain:
      with rows.plain_versions():
        spec.update_rows({'t': (uids, g, filled)}, state, tables)
    else:
      spec.update_rows({'t': (uids, g, filled)}, state, tables)
    torch.cuda.synchronize()
    assert [fn.launches for fn in rows.KERNEL_WRAPPERS] == (
        [0, 0] if plain else [0, 1])
    results.append((tables, state))
  (kt, ks), (pt, ps) = results
  assert kt['t'].shape == (500, 4, 5) and torch.equal(kt['t'], pt['t'])
  assert not torch.equal(kt['t'], table)
  for name in ks['t']:
    assert torch.equal(ks['t'][name], ps['t'][name])


# --- the eval step as one CUDA graph ------------------------------------------


def _suite():
  """The 13 metric keys; the diversity metrics over synthetic subtopics of
  the graded labels (a document of grade g covers subtopics 1..g)."""
  from ranking_tpu_torch.ops import metric_registry as registry
  fns = {}
  for key in registry.RankingMetricKey.all_keys():
    fn = registry.make_ranking_metric_fn(
        key, topn=None if key in ('arp', 'ordered_pair_accuracy') else 5)
    if key in ('alpha_dcg', 'precision_ia'):
      def fn(labels, logits, features=None, inner=fn):
        grades = torch.arange(1, 4, dtype=torch.float32, device=labels.device)
        sub = (labels[..., None] >= grades).to(torch.float32)
        return inner(torch.where(labels[..., None] >= 0, sub, -1.0), logits)
    fns[key] = fn
  return fns


def test_graphed_eval_step_equals_eager_bitwise(dev):
  """Replays of the captured eval step == the eager step bit for bit: the
  states of every metric and the val loss, and the logits; a padded batch
  (num_valid_rows), zeroed states after a pass, and a second batch shape
  (a second capture)."""
  from ranking_tpu_torch.data import batch as batch_lib
  from ranking_tpu_torch.models import scorers
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.train import steps
  gen = torch.Generator().manual_seed(5)
  model = scorers.RankingModel(scorers.DNNScorer((64, 32), in_features=12,
                                                 generator=gen),
                               transform_name='log1p').to(dev)

  def batch(b, l):
    labels = torch.randint(-1, 5, (b, l), generator=gen).float()
    x = torch.randn(b, l, 12, generator=gen) * 3
    return batch_lib.batch_from_labels(labels, examples={'x': x}).to(dev)

  fns = _suite()
  eager = steps.make_eval_step(
      fns, loss_fn=loss_registry.make_loss_fn('softmax_loss'), device=dev)
  graphed = steps.GraphedEvalStep(eager, dev)
  batches = [(batch(16, 40), None) for _ in range(3)] + [
      (batch(16, 40), 11), (batch(16, 24), None), (batch(16, 24), 9)]
  for _ in range(2):
    es = steps.init_metric_states(fns, with_loss=True, device=dev)
    gs = steps.init_metric_states(fns, with_loss=True, device=dev)
    for b, rows in batches:
      es, el = eager(model, b, es, num_valid_rows=rows)
      gs, gl = graphed(model, b, gs, num_valid_rows=rows)
      assert torch.equal(el, gl)
      for name in es:
        assert torch.equal(es[name].total, gs[name].total), name
        assert torch.equal(es[name].count, gs[name].count), name
  assert graphed.captures == 2 and graphed.replays == 2 * 6 - 2
  captured = graphed.captured_launches()['sorted_values_and_ranks']
  assert captured > 0
  assert graphed.replayed_launches()['sorted_values_and_ranks'] == (
      graphed.replays * captured // 2)


def test_graphed_eval_step_follows_new_parameters_and_models(dev):
  """Parameters loaded at new addresses (``assign=True``) and then another
  model drop the graphs and their memory pool: the step warms up and
  captures anew, and its replays equal the eager step bit for bit on the
  new weights."""
  from ranking_tpu_torch.data import batch as batch_lib
  from ranking_tpu_torch.models import scorers
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.train import steps
  gen = torch.Generator().manual_seed(6)

  def model():
    return scorers.RankingModel(
        scorers.DNNScorer((64, 32), in_features=12, generator=gen),
        transform_name='log1p').to(dev)

  def batch():
    labels = torch.randint(-1, 5, (16, 40), generator=gen).float()
    x = torch.randn(16, 40, 12, generator=gen) * 3
    return batch_lib.batch_from_labels(labels, examples={'x': x}).to(dev)

  fns = _suite()
  eager = steps.make_eval_step(
      fns, loss_fn=loss_registry.make_loss_fn('softmax_loss'), device=dev)
  graphed = steps.GraphedEvalStep(eager, dev)
  batches = [batch() for _ in range(4)]
  first = model()

  def run(m):
    es = steps.init_metric_states(fns, with_loss=True, device=dev)
    gs = steps.init_metric_states(fns, with_loss=True, device=dev)
    for b in batches:
      es, el = eager(m, b, es)
      gs, gl = graphed(m, b, gs)
      assert torch.equal(el, gl)
      for name in es:
        assert torch.equal(es[name].total, gs[name].total), name
        assert torch.equal(es[name].count, gs[name].count), name

  run(first)
  assert graphed.captures == 1 and graphed.replays == 3
  pool = graphed._pool
  fresh = {k: v.clone() + 0.25 * torch.randn(v.shape, generator=gen).to(dev)
           if v.is_floating_point() else v.clone()
           for k, v in model().state_dict().items()}
  first.load_state_dict(fresh, assign=True)
  run(first)
  assert graphed.captures == 2 and graphed.replays == 6
  assert graphed._pool != pool
  run(model())
  assert graphed.captures == 3 and graphed.replays == 9


@pytest.mark.parametrize('key,random', [('gumbel_approx_ndcg_loss', True),
                                        ('list_mle_loss', True),
                                        ('approx_ndcg_loss', False)])
def test_graphed_loss_zoo_steps_equal_eager_bitwise(dev, key, random):
  """K replays of a captured train step == K eager steps bit for bit for a
  Gumbel key and ListMLE drawing from a CUDA generator (registered with the
  graph; the eager copy starts from a copy of its state), and for approx
  NDCG with no generator (the kept draws, on the card before capture)."""
  import copy
  from ranking_tpu_torch.data import batch as batch_lib
  from ranking_tpu_torch.models import scorers
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.train import state as state_lib
  from ranking_tpu_torch.train import steps
  gen = torch.Generator().manual_seed(7)

  def batches(k):
    out = []
    for _ in range(k):
      labels = torch.randint(-1, 5, (16, 40), generator=gen).float()
      x = torch.randn(16, 40, 12, generator=gen) * 3
      out.append(batch_lib.batch_from_labels(labels, examples={'x': x}))
    return steps.stack_batches(out).to(dev)

  model = scorers.RankingModel(scorers.DNNScorer(
      (64, 32), in_features=12, dropout=0.0, generator=gen),
      transform_name='log1p')
  step = steps.make_train_step(loss_registry.make_loss_fn(key), device=dev)
  state = state_lib.create_train_state(model, state_lib.adam(1e-3),
                                       device=dev)
  rng = torch.Generator(device=dev).manual_seed(1) if random else None
  graphed = steps.make_multi_step(step, device=dev)
  eager = steps.make_multi_step(step, device=dev, eager=True)
  state, _ = graphed(state, batches(6), rng)
  twin = copy.deepcopy(state)
  twin_rng = None
  if random:
    twin_rng = torch.Generator(device=dev)
    twin_rng.set_state(rng.get_state())
  run = batches(6)
  state, got = graphed(state, run, rng)
  twin, want = eager(twin, run, twin_rng)
  assert graphed.captures == 1 and graphed.replays == 3 + 6
  assert torch.equal(got['loss'], want['loss'])
  for (name, a), b in zip(state.model.state_dict().items(),
                          twin.model.state_dict().values()):
    assert torch.equal(a, b), name


# The encoder's products (csrc/dense.cu): forward (bias in the epilogue),
# input gradient and weight gradient at BERT-base's train shapes (4,096
# rows of 768 and 3,072), and the forward at serving's 16,384 rows (the
# 128-document bucket: 128 candidates of 128 tokens).
DENSE_CASES = [(kind, m, k, n) for m, k, n in ((4096, 768, 768),
                                               (4096, 768, 3072),
                                               (4096, 3072, 768))
               for kind in ('forward', 'input_grad', 'weight_grad')] + [
                   ('forward', 16384, k, n)
                   for k, n in ((768, 768), (768, 3072), (3072, 768))]


@pytest.mark.parametrize('kind,m,k,n', DENSE_CASES)
def test_dense_kernel_against_float64(dev, kind, m, k, n):
  """The kernel's three TF32 passes keep about 22 bits: its largest error
  against a float64 product, over the largest output, stays under 2^-19
  (a single TF32 pass errs by some 2^-11 a product) and under cuBLAS
  float32's own at the same shape (1e-6 or so at these depths: sums of
  thousands of terms), with headroom of 1.5x for the draw."""
  gen = torch.Generator(device=dev).manual_seed(m + k + n)
  x = torch.randn(m, k, device=dev, generator=gen)
  w = torch.randn(k, n, device=dev, generator=gen) * k ** -0.5
  b = torch.randn(n, device=dev, generator=gen)
  dy = torch.randn(m, n, device=dev, generator=gen)
  before = dense.dense_gemm.launches
  if kind == 'forward':
    got, lib = dense._forward(x, w, b), torch.addmm(b, x, w)
    want = torch.addmm(b.double(), x.double(), w.double())
  elif kind == 'input_grad':
    got, lib = dense._input_grad(dy, w), dy @ w.t()
    want = dy.double() @ w.double().t()
  else:
    got, lib = dense._weight_grad(x, dy), x.t() @ dy
    want = x.double().t() @ dy.double()
    # The other orientation (dW^T written transposed) on the same operands.
    other = dense._weight_grad(dy, x)
    err_other = ((other.double() - want.t()).abs().max()
                 / want.abs().max()).item()
    assert err_other < 2.0 ** -19
  torch.cuda.synchronize()
  assert dense.dense_gemm.launches - before == (2 if kind == 'weight_grad'
                                                else 1)
  scale = want.abs().max()
  err = ((got.double() - want).abs().max() / scale).item()
  err_lib = ((lib.double() - want).abs().max() / scale).item()
  assert err < 2.0 ** -19, (err, err_lib)
  assert err <= 1.5 * err_lib, (err, err_lib)


def test_dense_kernel_bias_is_checked_and_cast(dev):
  """The kernel reads its bias as float32 of N: ``dense_gemm`` refuses any
  other, and ``DenseGeneral`` casts a bfloat16 module's bias for a float32
  input as the ``tensordot`` path does."""
  gen = torch.Generator(device=dev).manual_seed(9)
  x = torch.randn(4096, 768, device=dev, generator=gen)
  w = torch.randn(768, 768, device=dev, generator=gen) * 768 ** -0.5
  out = torch.empty(4096, 768, device=dev)
  planes = dense.split_planes(w, True)
  for bad in (torch.zeros(767, device=dev),
              torch.zeros(768, device=dev, dtype=torch.bfloat16),
              torch.zeros(768)):
    with pytest.raises(ValueError, match='bias'):
      dense.dense_gemm(x, False, planes, bad, out, False, 4096, 768, 768)
  from ranking_tpu_torch.models import layers
  layer = layers.DenseGeneral([768], [768], torch.Generator().manual_seed(9))
  with torch.no_grad():
    layer.bias.normal_(generator=torch.Generator().manual_seed(10))
  layer = layer.to(dev, torch.bfloat16)
  before = dense.dense_gemm.launches
  got = layer(x)
  assert dense.dense_gemm.launches - before == 1
  want = x.double() @ layer.kernel.double() + layer.bias.double()
  err = ((got.double() - want).abs().max() / want.abs().max()).item()
  assert err < 2.0 ** -19


def test_graphed_encoder_step_equals_eager_bitwise(dev):
  """K replays of a captured BERT-width train step == K eager steps bit for
  bit, with every block product through the kernel: 18 launches a layer
  (6 products, forward and two gradients) recorded at capture."""
  import copy
  from ranking_tpu_torch.data import batch as batch_lib
  from ranking_tpu_torch.data import dataset
  from ranking_tpu_torch.models import scorers
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.train import state as state_lib
  from ranking_tpu_torch.train import steps
  gen = torch.Generator().manual_seed(8)
  layers_, b, l, t = 2, 4, 4, 128   # 2,048 rows: the rule takes them

  def batches(k):
    out = []
    for _ in range(k):
      labels = torch.randint(0, 3, (b, l), generator=gen).float()
      ids = torch.randint(1000, 5000, (b, l, t), generator=gen)
      ids[..., 100:] = -1
      out.append(dataset.flatten_examples(batch_lib.batch_from_labels(
          labels, examples={'input_ids': ids})))
    return steps.stack_batches(out).to(dev)

  model = scorers.RankingModel(encoder.EncoderScorer(encoder.TransformerEncoder(
      5000, 768, layers_, 12, 3072, 128, dropout=0.0, generator=gen),
      dropout=0.0, generator=gen))
  step = steps.make_train_step(loss_registry.make_loss_fn('softmax_loss'),
                               device=dev)
  state = state_lib.create_train_state(model, state_lib.adam(1e-4),
                                       device=dev)
  graphed = steps.make_multi_step(step, device=dev)
  eager = steps.make_multi_step(step, device=dev, eager=True)
  state, _ = graphed(state, batches(4), None)
  assert graphed.captured_launches.get('dense_gemm') == 18 * layers_
  twin = copy.deepcopy(state)
  run = batches(4)
  state, got = graphed(state, run, None)
  twin, want = eager(twin, run, None)
  assert torch.equal(got['loss'], want['loss'])
  for (name, a), w in zip(state.model.state_dict().items(),
                          twin.model.state_dict().values()):
    assert torch.equal(a, w), name
