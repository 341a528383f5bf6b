"""The port's ``parallel/`` == the JAX package's, on the CPU.

In the pytest process: ``param_shardings``' rules and downgrades against
``ranking_tpu.parallel.param_shardings``, and ``sharded_pooled_lookup`` and
``sharded_pairwise_loss`` with their gradients (on a mesh of one rank)
against the JAX functions on the 8-device CPU mesh of ``tests/conftest.py``
(``data=2 x model=4``, the pairwise loss also with ``data_axis``). Then
one ``torch.multiprocessing`` spawn a world size, 2 and 4 (``data=2 x
model=2``), of gloo ranks (``tests/torch_dist_cases.py``): each collective
role's forward and gradient against one-process autograd over the stacked
inputs, and the sharded lookup and pairwise loss, each rank on its block,
against the JAX single-device results on the whole inputs.

Tolerances: roles and shardings exactly (integer plans; one-rank sums of
small integers in float32). Lookups and losses at rtol 1e-5 and atol 1e-6:
float32 sums of at most a few hundred terms in another order.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ranking_tpu import parallel as jpar
from ranking_tpu.models import embeddings as jax_emb
from ranking_tpu_torch import parallel
from ranking_tpu_torch.data import batch as batch_lib
from ranking_tpu_torch.parallel import mesh as mesh_lib

import torch_dist_cases

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

VOCAB, DIM = 32, 5
B, L = 4, 8
WORLDS = {2: (1, 2), 4: (2, 2)}   # world -> (data, model)


def _close(got, want, err_msg=''):
  np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                             atol=1e-6, err_msg=err_msg)


def _spec_dim(spec):
  spec = tuple(spec)
  return spec.index('model') if 'model' in spec else None


# ------------------------------------------------------------- shardings


def _encoder_params(heads, mlp):
  hid = 8
  blk = {'MultiHeadDotProductAttention_0': {
      n: {'kernel': np.zeros((hid, heads, hid // heads)),
          'bias': np.zeros((heads, hid // heads))}
      for n in ('query', 'key', 'value')}}
  blk['MultiHeadDotProductAttention_0']['out'] = {
      'kernel': np.zeros((heads, hid // heads, hid)), 'bias': np.zeros(hid)}
  blk['Dense_0'] = {'kernel': np.zeros((hid, mlp)), 'bias': np.zeros(mlp)}
  blk['Dense_1'] = {'kernel': np.zeros((mlp, hid)), 'bias': np.zeros(hid)}
  return {'scorer': {'encoder': {
      'block_0': blk, 'token_embed': {'embedding': np.zeros((64, hid))},
      'pos_embed': {'embedding': np.zeros((6, hid))},
      'pooler': {'kernel': np.zeros((hid, hid)), 'bias': np.zeros(hid)}},
      'embed_q': {'embedding': np.zeros((10, 4))},
      'tower': {'Dense_0': {'kernel': np.zeros((8, 4))}}}}


def _flat(tree, prefix=''):
  out = {}
  for k, v in tree.items():
    path = f'{prefix}/{k}' if prefix else k
    if isinstance(v, dict):
      out.update(_flat(v, path))
    else:
      out[path] = v
  return out


@pytest.mark.parametrize('model,heads,mlp,rules', [
    (4, 4, 16, 'default'), (4, 4, 16, 'encoder'), (2, 4, 16, 'encoder'),
    (4, 2, 6, 'encoder'), (2, 3, 16, 'encoder')])
def test_param_shardings_rules_and_downgrades_equal_jax(model, heads, mlp,
                                                        rules):
  jmesh = jpar.make_mesh(model=model)
  jrules = jpar.DEFAULT_RULES if rules == 'default' else jpar.ENCODER_TP_RULES
  trules = (parallel.DEFAULT_RULES if rules == 'default'
            else parallel.ENCODER_TP_RULES)
  params = _encoder_params(heads, mlp)
  want = _flat(jax.tree.map(lambda s: s.spec, jpar.param_shardings(
      jax.tree.map(jnp.asarray, params), jmesh, jrules)))
  got = parallel.param_shardings(_flat(params),
                                 parallel.Mesh(8 // model, model), trules)
  assert got == {k: _spec_dim(v) for k, v in want.items()}
  # The port's rules are the JAX package's, spec for spec.
  assert [(p, tuple(s)) for p, s in jrules] == [
      (p, tuple(s)) for p, s in trules]
  # shard_params keeps each rank's slice.
  mesh = parallel.Mesh(8 // model, model, rank=model - 1)
  shards = parallel.shard_params(_flat(params), mesh, trules)
  for path, dim in got.items():
    whole = _flat(params)[path]
    if dim is None:
      assert shards[path].shape == whole.shape
    else:
      assert shards[path].shape[dim] * model == whole.shape[dim]


def test_mesh_layout_and_batch_shards():
  mesh = parallel.make_mesh()
  assert (mesh.data, mesh.model, mesh.rank, mesh.distributed) == (
      1, 1, 0, False)
  assert mesh.shape == {'data': 1, 'model': 1}
  # Rank r sits at (r // model, r % model), as the JAX mesh's devices.
  jmesh = jpar.make_mesh(model=4)
  for rank, device in enumerate(np.asarray(jmesh.devices).reshape(-1)):
    m = parallel.Mesh(2, 4, rank=rank)
    assert (m.data_index, m.model_index) == tuple(
        int(i[0]) for i in np.where(np.asarray(jmesh.devices) == device))
  labels = np.arange(24, dtype=np.float32).reshape(6, 4)
  x = np.arange(6 * 4 * 3, dtype=np.float32).reshape(6, 4, 3)
  batch = batch_lib.batch_from_labels(labels, context={'q': np.arange(6)},
                                      examples={'x': x})
  flat = batch.replace(examples={'x': batch.examples['x'].reshape(24, 3)})
  for rank in range(3):
    m = parallel.Mesh(3, 1, rank=rank)
    for b in (batch, flat):
      part = parallel.shard_batch(b, m)
      np.testing.assert_array_equal(part.labels, labels[2 * rank:
                                                        2 * rank + 2])
      np.testing.assert_array_equal(part.context['q'],
                                    [2 * rank, 2 * rank + 1])
      np.testing.assert_array_equal(
          part.examples['x'].reshape(2, 4, 3), x[2 * rank:2 * rank + 2])
  assert parallel.shard_batch(batch, mesh) is batch
  assert mesh_lib.default_data_size(12, 8, 1) == 6
  with pytest.warns(UserWarning, match='2 ranks idle'):
    assert mesh_lib.default_data_size(12, 8, 1) == 6


# ------------------------------------------- functions against the JAX mesh


def _lookup_inputs(seed=0):
  rng = np.random.RandomState(seed)
  table = rng.randn(VOCAB, DIM).astype(np.float32)
  ids = rng.randint(-1, VOCAB + 6, size=(8, 3, 4)).astype(np.int32)
  ids[0, 0] = -1                  # a bag of padding only
  cot = rng.randn(8, 3, DIM).astype(np.float32)
  return table, ids, cot


def _jax_lookup(table, ids, cot, combiner, mesh=None):
  fn = ((lambda t: jpar.sharded_pooled_lookup(t, jnp.asarray(ids), mesh,
                                              combiner)) if mesh is not None
        else (lambda t: jax_emb.pooled_lookup(t, jnp.asarray(ids), combiner)))
  out, vjp = jax.vjp(fn, jnp.asarray(table))
  return np.asarray(out), np.asarray(vjp(jnp.asarray(cot))[0])


@pytest.mark.parametrize('combiner', ['mean', 'sum', 'sqrtn'])
def test_sharded_pooled_lookup_equals_jax(combiner):
  table, ids, cot = _lookup_inputs()
  want, want_grad = _jax_lookup(table, ids, cot, combiner,
                                jpar.make_mesh(model=4))
  t = torch.from_numpy(table).requires_grad_()
  got = parallel.sharded_pooled_lookup(t, torch.from_numpy(ids),
                                       parallel.make_mesh(), combiner)
  (got * torch.from_numpy(cot)).sum().backward()
  _close(got.detach(), want)
  _close(t.grad, want_grad)
  with pytest.raises(ValueError, match='combiner'):
    parallel.sharded_pooled_lookup(t, torch.from_numpy(ids),
                                   parallel.make_mesh(), 'max')


def test_sharded_encoder_pads_its_table_and_keeps_the_rank_rows():
  gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
  from ranking_tpu_torch.models import embeddings as emb
  whole = emb.EmbeddingEncoder(VOCAB, DIM, generator=gen()).embedding
  for model in (1, 2, 4):
    for rank in range(model):
      mesh = parallel.Mesh(1, model, rank=rank)
      enc = parallel.ShardedEmbeddingEncoder(VOCAB, DIM, mesh,
                                             generator=gen())
      rows = VOCAB // model
      assert torch.equal(enc.embedding.detach(),
                         whole.detach()[rank * rows:(rank + 1) * rows])
      assert mesh_lib.sharded_dims(enc) == {'embedding': 0}
  # A vocabulary the model axis does not divide is padded, as in JAX.
  enc = parallel.ShardedEmbeddingEncoder(10, DIM, parallel.Mesh(1, 4, 3))
  assert enc.embedding.shape == (3, DIM)


def _pairwise_inputs(seed=0):
  rng = np.random.RandomState(seed)
  labels = rng.randint(0, 4, size=(B, L)).astype(np.float32)
  labels[rng.rand(B, L) < 0.2] = -1.0
  labels[0] = -1.0                           # a list with no valid item
  logits = rng.randn(B, L).astype(np.float32)
  logits[1, 1] = logits[1, 2]                # a tied pair
  weights = rng.uniform(0.0, 2.0, size=(B, L)).astype(np.float32)
  weights[2, 3] = 0.0
  return labels, logits, weights


_KINDS = [(k, r) for k in ('logistic', 'hinge', 'soft_zero_one')
          for r in ('sum', 'mean', 'sum_by_nonzero_weights')]


@functools.lru_cache(maxsize=None)
def _jax_pairwise_all(data_axis, model=4):
  """``{(kind, reduction): (loss, gradient)}`` of the JAX function on the
  pairwise inputs over the 8-device mesh, every case in one jit."""
  from ranking_tpu.ops.reductions import Reduction as JReduction
  labels, logits, weights = _pairwise_inputs()
  mesh = jpar.make_mesh(model=model)

  def all_cases(x):
    return {f'{kind}/{red}': jax.value_and_grad(
        lambda y, kind=kind, red=red: jpar.sharded_pairwise_loss(
            jnp.asarray(labels), y, mesh, axis='model', loss_kind=kind,
            weights=jnp.asarray(weights), reduction=JReduction(red),
            data_axis=data_axis))(x) for kind, red in _KINDS}
  out = jax.jit(all_cases)(jnp.asarray(logits))
  return {tuple(k.split('/')): (np.asarray(v[0]), np.asarray(v[1]))
          for k, v in out.items()}


@pytest.mark.parametrize('kind,red', _KINDS)
def test_sharded_pairwise_loss_equals_jax(kind, red):
  labels, logits, weights = _pairwise_inputs()
  for data_axis in (None, 'data'):
    want, want_grad = _jax_pairwise_all(data_axis)[(kind, red)]
    x = torch.from_numpy(logits).requires_grad_()
    got = parallel.sharded_pairwise_loss(
        torch.from_numpy(labels), x, parallel.make_mesh(), loss_kind=kind,
        weights=torch.from_numpy(weights), reduction=red,
        data_axis=data_axis)
    got.backward()
    _close(got.detach(), want, err_msg=f'{kind} {red} {data_axis}')
    _close(x.grad, want_grad, err_msg=f'{kind} {red} {data_axis}')


def test_sharded_pairwise_loss_tie_gradient_follows_the_jnp_formula():
  """At a tied pair the logistic gradient is -1, the jnp formula's (the
  Pallas kernel and the port's pairwise loss give -0.5)."""
  labels = np.array([[1.0, 0.0]], np.float32)
  logits = np.zeros((1, 2), np.float32)
  want = jax.grad(lambda y: jpar.sharded_pairwise_loss(
      jnp.asarray(labels), y, jpar.make_mesh(jax.devices()[:2], model=2),
      reduction='sum'))(jnp.asarray(logits))
  want = np.asarray(want)
  x = torch.from_numpy(logits).requires_grad_()
  parallel.sharded_pairwise_loss(torch.from_numpy(labels), x,
                                 parallel.make_mesh(), reduction='sum'
                                 ).backward()
  np.testing.assert_array_equal(x.grad.numpy(), want)
  assert want[0, 0] == -1.0


# -------------------------------------------------- ranks, spawned on gloo


def _fused_inputs():
  """A 3-layer tower's input [12, 5], a ragged row mask (the two halves
  hold 5 and 2 valid rows), its parameters and an output cotangent."""
  rng = np.random.RandomState(6)
  dims = (5, 8, 6, 4)
  mask = np.zeros(12, np.float32)
  mask[[0, 1, 2, 4, 5, 7, 10]] = 1.0
  weights = [rng.randn(o, i).astype(np.float32) * 0.5
             for i, o in zip(dims[:-1], dims[1:])]
  biases, gammas, betas = ([rng.randn(o).astype(np.float32) * s + c
                            for o in dims[1:]]
                           for s, c in ((0.1, 0.0), (0.2, 1.0), (0.1, 0.0)))
  return {'x': rng.randn(12, 5).astype(np.float32), 'mask': mask,
          'params': [weights, biases, gammas, betas],
          'cot': rng.randn(12, 4).astype(np.float32)}


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
  """Every rank's results of the roles, lookup and pairwise cases, at
  world 2 and world 4: one spawn a world. The roles run over a data group
  of 2: the whole world 2, each half of world 4's 2 x 2."""
  rng = np.random.RandomState(5)
  table, ids, cot = _lookup_inputs(1)
  labels, logits, weights = _pairwise_inputs()
  runs = {}
  for world, (data, model) in WORLDS.items():
    roles = {'xs': rng.randn(2, 2, 3).astype(np.float32),
             'cs': rng.randn(2, 2, 3).astype(np.float32),
             'cg': rng.randn(2, 4, 3).astype(np.float32)}
    inputs = {
        'roles': ((2, world // 2), roles),
        'fused_bn': ((2, world // 2), _fused_inputs()),
        'lookup': ((data, model), {'table': table, 'ids': ids, 'cot': cot}),
        'pairwise': ((data, model), {'labels': labels, 'logits': logits,
                                     'weights': weights}),
    }
    runs[world] = (str(tmp_path_factory.mktemp(f'world{world}')), inputs)
  results = torch_dist_cases.spawn(runs)
  return {world: (runs[world][1], results[world]) for world in runs}


def _results(ranks, world, case):
  inputs, per_rank = ranks[world]
  for r in per_rank:
    assert 'error' not in r[case], r[case].get('error')
  return inputs[case], [r[case] for r in per_rank]


@pytest.mark.parametrize('world', sorted(WORLDS))
def test_collective_roles_and_gradients_equal_one_process_autograd(ranks,
                                                                   world):
  """Forward and gradient of each role against autograd in one process over
  the stacked inputs, where the group's loss is the sum of every rank's
  (a replicated consumer counted once)."""
  ((_, model), inp), got = _results(ranks, world, 'roles')
  xs, cs, cg = (torch.from_numpy(inp[k]) for k in ('xs', 'cs', 'cg'))

  def grad(fn, x):
    x = x.clone().requires_grad_()
    fn(x).backward()
    return x.grad.numpy()

  want = {
      'reduce': (xs.sum(0), grad(lambda s: (s.sum(0) * cs[0]).sum(), xs)),
      'copy': (xs[0], grad(lambda x: (x * cs[0]).sum() + (x * cs[1]).sum(),
                           xs[0])),
      'gather': (xs.reshape(4, 3), grad(
          lambda s: (s.reshape(4, 3) * cg[0]).sum()
          + (s.reshape(4, 3) * cg[1]).sum(), xs)),
      'gather_replicated': (xs.reshape(4, 3), grad(
          lambda s: (s.reshape(4, 3) * cg[0]).sum(), xs)),
      'sum_over': (xs.sum(0), grad(
          lambda s: (s.sum(0) * cs[0]).sum() + (s.sum(0) * cs[1]).sum(), xs)),
  }
  for rank, res in enumerate(got):
    r = rank // model
    assert res['feed']   # local_batch_to_global(shard_batch(b)) == b
    for name, (y, g) in want.items():
      got_y, got_g = res[name]
      np.testing.assert_allclose(got_y, np.asarray(y), rtol=1e-6,
                                 err_msg=name)
      want_g = g if name == 'copy' else g[r]
      np.testing.assert_allclose(got_g, want_g, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize('world', sorted(WORLDS))
def test_fused_bn_op_over_the_data_group_equals_one_process(ranks, world):
  """``fused_bn_mlp`` on each rank's rows of a ragged mask, its moments
  summed over the data group between the layers and its backward terms
  between the products, against autograd through ``reference_bn_mlp`` on
  the whole batch in one process (rtol 1e-5, atol 1e-6 as above; the
  biases, zero in theory, to their rounding bound)."""
  from ranking_tpu_torch.ops.cuda import fused_bn
  ((_, model), inp), got = _results(ranks, world, 'fused_bn')
  x = torch.from_numpy(inp['x']).requires_grad_()
  params = [[torch.from_numpy(p).requires_grad_() for p in group]
            for group in inp['params']]
  out, means, vars_ = fused_bn.reference_bn_mlp(
      x, *params, mask=torch.from_numpy(inp['mask']))
  (out * torch.from_numpy(inp['cot'])).sum().backward()
  for rank, res in enumerate(got):
    lo = (rank // model) * 6
    _close(res['out'], out.detach()[lo:lo + 6])
    _close(res['dx'], x.grad[lo:lo + 6])
    for g, w in zip(res['means'] + res['vars'], means + vars_):
      _close(g, w.detach())
    for i, (g_group, w_group) in enumerate(zip(res['grads'], params)):
      for g, w in zip(g_group, w_group):
        if i == 1:
          # A bias in front of a BN: zero in theory (the BN takes the
          # batch mean out); both sides are float32 rounding of sums of
          # 12 rows of O(1) terms, within 12 * 2^-23 * 10.
          bound = 12 * 2.0 ** -23 * 10
          assert np.abs(g).max() <= bound and w.grad.abs().max() <= bound
        else:
          _close(g, w.grad)


@pytest.mark.parametrize('world', sorted(WORLDS))
def test_ranks_sharded_pooled_lookup_equals_jax_single_device(ranks, world):
  ((data, model), inp), got = _results(ranks, world, 'lookup')
  for combiner in ('mean', 'sum', 'sqrtn'):
    want, want_grad = _jax_lookup(inp['table'], inp['ids'], inp['cot'],
                                  combiner)
    rows = VOCAB // model
    for rank, res in enumerate(got):
      d, m = divmod(rank, model)
      out, grad = res[combiner]
      per = inp['ids'].shape[0] // data
      _close(out, want[d * per:(d + 1) * per], err_msg=combiner)
      _close(grad, want_grad[m * rows:(m + 1) * rows], err_msg=combiner)


@pytest.mark.parametrize('world', sorted(WORLDS))
def test_ranks_sharded_pairwise_loss_equals_jax_single_device(ranks, world):
  """Against the JAX function's result, which is the single-device loss
  (the JAX package's own tests)."""
  ((data, model), inp), got = _results(ranks, world, 'pairwise')
  for kind, red in _KINDS:
    want, want_grad = _jax_pairwise_all(None)[(kind, red)]
    grad = np.zeros_like(want_grad)
    for res in got:
      loss, g, (r0, c0) = res[(kind, red)]
      _close(loss, want, err_msg=f'{kind} {red}')
      grad[r0:r0 + g.shape[0], c0:c0 + g.shape[1]] = g
    _close(grad, want_grad, err_msg=f'{kind} {red}')
