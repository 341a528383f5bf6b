"""The port's row scatters (``ops/cuda/rows.py``) == the JAX package's, on
the CPU.

On CPU tensors the wrappers compute their plain versions, which are held
bitwise against ``ranking_tpu.ops.pallas.rows.scatter_rows_reference`` (a
scatter copies bits, so nothing less counts). The Pallas kernel itself is
not run here: the JAX package's own tests hold it to that reference in
interpret mode, and its sparse step takes the reference on the CPU. The
CUDA kernel is held to the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ranking_tpu.ops.pallas import rows as jax_rows
from ranking_tpu_torch.ops.cuda import rows
from ranking_tpu_torch.train import sparse

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

V, D = 200, 8


def _case(k, n, seed, kind='mixed'):
  """n tables [V, D] and n update slabs [K, D] (float32 numpy), ids and
  valid flags: unique ids among valid slots, plus invalid slots, negative
  ids and ids >= V."""
  rng = np.random.RandomState(seed)
  tables = [rng.randn(V, D).astype(np.float32) for _ in range(n)]
  updates = [rng.randn(k, D).astype(np.float32) for _ in range(n)]
  ids = rng.permutation(V)[:k].astype(np.int32)
  valid = rng.rand(k) > 0.25
  if kind == 'mixed' and k >= 4:
    ids[0], ids[1] = -3, V + 5       # out of range either side, still valid
    valid[0] = valid[1] = True
    ids[2] = ids[3]                  # a duplicate id on an invalid slot
    valid[2] = False
  if kind == 'all_invalid':
    valid[:] = False
  return tables, updates, ids, valid


def _jax_want(tables, updates, ids, valid, dtype):
  return [np.asarray(jax_rows.scatter_rows_reference(
      jnp.asarray(t).astype(dtype), jnp.asarray(ids), jnp.asarray(valid),
      jnp.asarray(u).astype(dtype)).astype(jnp.float32))
          for t, u in zip(tables, updates)]


_DTYPES = {'float32': (torch.float32, jnp.float32),
           'bfloat16': (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize('dtype', sorted(_DTYPES))
@pytest.mark.parametrize('n', [1, 2, 3])
@pytest.mark.parametrize('k,kind', [(64, 'mixed'), (1, 'mixed'), (0, 'mixed'),
                                    (37, 'all_invalid'), (V, 'mixed')])
def test_plain_scatters_equal_the_jax_reference_bitwise(k, kind, n, dtype):
  tdt, jdt = _DTYPES[dtype]
  tables, updates, ids, valid = _case(k, n, seed=k + n, kind=kind)
  want = _jax_want(tables, updates, ids, valid, jdt)
  t_tables = [torch.from_numpy(t).to(tdt) for t in tables]
  t_updates = [torch.from_numpy(u).to(tdt) for u in updates]
  before = [t.clone() for t in t_tables]
  out = rows.scatter_rows_multi(t_tables, torch.from_numpy(ids),
                                torch.from_numpy(valid), t_updates)
  for got, w, t, b in zip(out, want, t_tables, before):
    assert got is t and got.dtype == tdt      # in place, dtype kept
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), w)
  # The same through the n = 1 wrapper and the plain version directly.
  for t, b, u, w in zip(before, t_tables, t_updates, want):
    single = rows.scatter_rows(t.clone(), torch.from_numpy(ids),
                               torch.from_numpy(valid).to(torch.int32), u)
    np.testing.assert_array_equal(single.to(torch.float32).numpy(), w)
    plain = rows.scatter_rows_reference(t.clone(), torch.from_numpy(ids),
                                        torch.from_numpy(valid), u)
    np.testing.assert_array_equal(plain.to(torch.float32).numpy(), w)
  assert rows.scatter_rows.launches == rows.scatter_rows_multi.launches == 0


def test_untouched_rows_keep_their_bits():
  tables, updates, ids, valid = _case(50, 1, seed=3)
  table = torch.from_numpy(tables[0])
  before = table.clone()
  rows.scatter_rows(table, torch.from_numpy(ids), torch.from_numpy(valid),
                    torch.from_numpy(updates[0]))
  written = set(ids[valid & (ids >= 0) & (ids < V)].tolist())
  for r in range(V):
    if r not in written:
      assert torch.equal(table[r], before[r])


def test_multi_wrapper_refuses_mismatched_operands():
  t = [torch.zeros(V, D) for _ in range(3)]
  u = [torch.zeros(4, D) for _ in range(3)]
  ids, valid = torch.arange(4), torch.ones(4, dtype=torch.bool)
  with pytest.raises(ValueError, match='equally many'):
    rows.scatter_rows_multi(t, ids, valid, u[:2])
  with pytest.raises(ValueError, match='equally many'):
    rows.scatter_rows_multi([], ids, valid, [])
  with pytest.raises(ValueError, match='share shape/dtype'):
    rows.scatter_rows_multi([t[0], torch.zeros(V, D + 1)], ids, valid, u[:2])
  with pytest.raises(ValueError, match='share shape/dtype'):
    rows.scatter_rows_multi([t[0], t[1].to(torch.bfloat16)], ids, valid,
                            u[:2])
  with pytest.raises(ValueError, match='update slabs must share shape'):
    rows.scatter_rows_multi(t[:2], ids, valid, [u[0], torch.zeros(5, D)])
  with pytest.raises(ValueError, match='ids/valid must be shape'):
    rows.scatter_rows_multi(t, ids[:3], valid, u)
  with pytest.raises(ValueError, match='ids/valid must be shape'):
    rows.scatter_rows_multi(t, ids, valid[:3], u)


@pytest.mark.parametrize('shape', [(V, D), (V, 2, D // 2)])
def test_routing_sends_every_table_to_the_wrappers(monkeypatch, shape):
  """Switched on, the n buffers of one update go to one multi-table call,
  whatever the width, the table's size or its number of dims (the JAX
  auto-domain is a TPU crossover): a table of more than two dims goes as a
  [V, -1] view of its own storage. Switched off, they take the plain
  version."""
  calls = []
  real_multi, real_single = rows.scatter_rows_multi, rows.scatter_rows
  monkeypatch.setattr(rows, 'scatter_rows_multi', lambda *a: (
      calls.append(('multi', [tuple(t.shape) for t in a[0]])),
      real_multi(*a))[1])
  monkeypatch.setattr(rows, 'scatter_rows', lambda *a: (
      calls.append(('single', [tuple(a[0].shape)])), real_single(*a))[1])
  tables, updates, ids, valid = _case(9, 3, seed=5)
  bufs = [torch.from_numpy(t).reshape(shape) for t in tables]
  new = [torch.from_numpy(u).reshape((9,) + shape[1:]) for u in updates]
  args = (torch.from_numpy(ids), torch.from_numpy(valid))
  want = rows.scatter_rows_multi_reference([b.clone() for b in bufs], *args,
                                           new)
  out = sparse._scatter_rows_multi_auto(bufs, *args, new, True)
  for o, b, w in zip(out, bufs, want):
    assert o is b and o.shape == shape and torch.equal(o, w)
  sparse._scatter_rows_multi_auto(bufs[:1], *args, new[:1], True)
  assert calls == [('multi', [(V, D)] * 3), ('multi', [(V, D)]),
                   ('single', [(V, D)])]
  sparse._scatter_rows_multi_auto(bufs, *args, new, False)
  assert len(calls) == 3
  rows.set_enabled(False)
  try:
    assert not rows.enabled()
  finally:
    rows.set_enabled(None)
  assert rows.enabled()


def test_plain_version_drops_ids_beyond_int32():
  """An int64 id at or above 2^31 is out of range, never wrapped into the
  table (the kernel compares int64 ids in 64 bits)."""
  table = torch.zeros(V, D)
  ids = torch.tensor([2 ** 32 + 5, 2 ** 31, 7], dtype=torch.int64)
  rows.scatter_rows(table, ids, torch.ones(3, dtype=torch.bool),
                    torch.ones(3, D))
  assert table.sum(dim=1).nonzero().flatten().tolist() == [7]


def test_plain_versions_context_restores():
  with rows.plain_versions():
    assert rows._PLAIN
    with rows.plain_versions():
      pass
    assert rows._PLAIN
  assert not rows._PLAIN
