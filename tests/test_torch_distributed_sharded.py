"""The port's model-sharded steps == the JAX single-device steps on the
global batch, over gloo ranks on the CPU.

As ``tests/test_torch_distributed.py`` (world 2 as ``model=2`` here, and
world 4 as ``data=2 x model=2``; one ``torch.multiprocessing`` spawn):

* two sparse steps of an ``EmbeddingDNNScorer`` whose tables are
  row-sharded over the model group (LazyAdam, LazyAdagrad), and two steps
  of its dense-gradient lazy update;
* one train step of the transformer encoder under ``ENCODER_TP_RULES``
  (the JAX package's own test, ``tests/test_parallel.py:242-295``, with
  its reason to skip ``key/bias``), the same with remat, bitwise, and with
  global-norm clipping against one process's clipped step.

The ranks start first and run while this process computes the JAX
references (in threads: XLA compiles with the GIL released).
``tests/test_torch_distributed_pipeline.py`` holds the pipeline over the
mesh.

Tolerances, as the one-card tests of the same steps derive them
(``tests/test_torch_sparse.py``, ``tests/test_parallel.py``): the sparse
step's floats at rtol 1e-5 and 1e-5 of the array's largest magnitude (the
slab's gradient adds a row's token contributions in another order, here
also over ranks); the encoder at rtol 1e-5 atol 1e-5 for the parameters
and rtol 1e-5 atol 1e-6 for the loss. The dense Adam runs at eps 0.1 in the sparse steps
and 1e-3 in the encoder's, for ``tests/test_torch_sparse.py``'s reason
(their output biases have a true gradient of 0 under the shift-invariant
softmax loss, whose rounding noise Adam would turn into moves of a whole
rate).
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import optax
import pytest
import torch

from ranking_tpu import models as jax_models
from ranking_tpu import ops as jax_ops
from ranking_tpu import train as jax_train
from ranking_tpu.data import batch as jax_batch
from ranking_tpu.models import encoder as jax_enc
from ranking_tpu.train import sparse as jax_sparse
from ranking_tpu_torch import convert

import torch_dist_cases
from torch_dist_refs import WORLDS, assert_tree_close, case, close, grid
from torch_dist_refs import randomized

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

L = 6


VOCAB, DIM, SB, ST = 200, 8, 4, 3
SHIDDEN = (8, 4)
SLR = 1e-2


def _sparse_arrays(seed):
  rng = np.random.RandomState(seed)
  labels = rng.randint(0, 5, size=(SB, L)).astype(np.float32)
  labels[0, -2:] = -1.0
  labels[3, 1:] = -1.0
  docs = rng.randint(0, VOCAB, size=(SB, L, ST)).astype(np.int32)
  docs[rng.rand(SB, L, ST) < 0.125] = -1
  query = rng.randint(0, VOCAB, size=(SB, ST)).astype(np.int32)
  return labels, {'query_tokens': query}, {'document_tokens': docs}


def _jax_sparse(arrays, kind='adam', dense=False):
  """The randomized variables, the embed features, and a function that
  runs the JAX steps on the global batches: (per-step metrics, final
  params, final sparse optimizer state)."""
  model = jax_models.RankingModel(scorer=jax_models.EmbeddingDNNScorer(
      hidden_layer_dims=SHIDDEN,
      vocab_sizes={'query_tokens': VOCAB, 'document_tokens': VOCAB},
      embedding_dim=DIM, dropout=0.0, use_batch_norm=False))
  batches = [jax_batch.batch_from_labels(labels=a[0], context=a[1],
                                         examples=a[2]) for a in arrays]
  if kind == 'adam':
    tx, sp = optax.adam(SLR, eps=0.1), jax_sparse.LazyAdam(SLR)
  else:
    tx, sp = optax.adagrad(SLR), jax_sparse.LazyAdagrad(SLR)
  state = jax_train.create_train_state(
      model, tx, jax.random.PRNGKey(0), batches[0].context,
      batches[0].examples, batches[0].mask, sparse_tx=sp)
  params = randomized(jax.tree.map(np.asarray, state.params), 7)
  state = state.replace(params=params, opt_state=tx.init(
      jax_sparse.partition(params, sp)[0]))
  efs = jax_sparse.derive_embed_features(state.params, batches[0].context,
                                         batches[0].examples)

  def run(state=state):
    loss = jax_ops.make_loss_fn('softmax_loss')
    step = jax.jit(jax_train.make_train_step(loss) if dense
                   else jax_train.make_sparse_train_step(loss, efs))
    metrics = []
    for b in batches:
      state, m = step(state, b, jax.random.PRNGKey(1))
      metrics.append({k: np.asarray(v) for k, v in m.items()})
    return (metrics, jax.tree.map(np.asarray, state.params),
            jax.tree.map(np.asarray, state.sparse_opt_state))
  return {'params': params}, efs, run


# (case, lazy optimizer, the dense-gradient lazy update instead of the
# sparse step)
_SPARSE_CASES = (('sparse', 'adam', False), ('sparse_adagrad', 'adagrad',
                                              False),
                 ('lazy_dense', 'adam', True))


TP_CONFIG = dict(vocab_size=48, hidden_dim=16, num_layers=2, num_heads=4,
                 mlp_dim=32, max_len=8, dropout=0.0)


def _jax_tp():
  """The JAX package's TP test's single-device step, at Adam eps 1e-3 in
  both packages: the score bias has a true gradient of 0 under the
  shift-invariant softmax loss (as the DNN's output bias in
  ``tests/test_torch_train.py``), and at eps 1e-8 Adam turns its
  summation-order noise into moves of a whole learning rate. Returns the
  variables, labels and ids, and a function that runs the step: (loss,
  final params)."""
  rng = np.random.RandomState(1)
  labels = rng.randint(0, 3, size=(8, 3)).astype(np.float32)
  labels[:, -1] = -1.0
  ids = rng.randint(0, 48, size=(8, 3, 8)).astype(np.int32)
  batch = jax_batch.batch_from_labels(labels=labels,
                                      examples={'input_ids': ids})
  model = jax_models.RankingModel(scorer=jax_enc.EncoderScorer(
      encoder=jax_enc.TransformerEncoder(**TP_CONFIG), dropout=0.0))
  state = jax_train.create_train_state(
      model, optax.adam(1e-2, eps=1e-3), jax.random.PRNGKey(0),
      batch.context, batch.examples, batch.mask)
  variables = {'params': jax.tree.map(np.asarray, state.params)}

  def run(state=state):
    step = jax.jit(jax_train.make_train_step(
        jax_ops.make_loss_fn('softmax_loss')))
    state, m = step(state, batch, jax.random.PRNGKey(2))
    return float(m['loss']), jax.tree.map(np.asarray, state.params)
  return variables, labels, ids, run


@pytest.fixture(scope='module')
def world_runs(tmp_path_factory):
  """The JAX references' weights, one spawn running every case at each
  world size, and the JAX steps while the ranks run."""
  sparse_arrays = [_sparse_arrays(10 + i) for i in range(2)]
  inits = {name: _jax_sparse(sparse_arrays, kind, dense)
           for name, kind, dense in _SPARSE_CASES}
  inits['tp'] = _jax_tp()
  runs = {}
  for world in WORLDS:
    inputs = {}
    for name, kind, dense in _SPARSE_CASES:
      svars, efs, _ = inits[name]
      inputs[name] = (grid(world, True), {
          'state': dict(convert.from_flax(svars)), 'batches': sparse_arrays,
          'hidden': SHIDDEN, 'dim': DIM, 'lr': SLR, 'kind': kind,
          'dense': dense,
          'vocab_sizes': {'query_tokens': VOCAB, 'document_tokens': VOCAB},
          'efs': [dict(vars(e)) for e in efs]})
    tvars, tlabels, tids, _ = inits['tp']
    inputs['tp'] = (grid(world, True), {
        'state': dict(convert.from_flax(tvars)), 'config': TP_CONFIG,
        'labels': tlabels, 'input_ids': tids})
    runs[world] = (str(tmp_path_factory.mktemp(f'ranks{world}')), inputs)
  started = torch_dist_cases.start(runs)
  with ThreadPoolExecutor(len(inits)) as pool:
    done = {name: pool.submit(init[-1]) for name, init in inits.items()}
    refs = {name: ((inits[name][0], inits[name][1]) + done[name].result(),
                   sparse_arrays) for name, _, _ in _SPARSE_CASES}
    refs['tp'] = inits['tp'][:3] + done['tp'].result()
  return refs, torch_dist_cases.join(started), None


# ------------------------------------------------------------------ tests


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('name', [c[0] for c in _SPARSE_CASES])
def test_sparse_step_on_row_sharded_tables_equals_jax_single_device(
    world_runs, world, name):
  ((svars, _, want_metrics, want_params, want_opt), _), runs = case(
      world_runs, world, name)
  data, model = grid(world, True)
  before = convert.to_flax(convert.from_flax(svars))['params']
  for rank, res in enumerate(runs):
    out = res[name]
    assert set(out['local_rows'].values()) == {VOCAB // model}
    for got_m, want_m in zip(out['metrics'], want_metrics):
      close(got_m['loss'], want_m['loss'], err_msg='loss')
    got = convert.to_flax({k: torch.from_numpy(v)
                           for k, v in out['state'].items()})['params']

    def check(path, g, w):
      scale = max(float(np.abs(w).max()), 1e-30)
      close(g, w, atol=1e-5 * scale, err_msg=jax.tree_util.keystr(path))
    jax.tree_util.tree_map_with_path(check, got, want_params)
    for feat in ('query_tokens', 'document_tokens'):
      path = f'scorer/embed_{feat}/embedding'
      old = before['scorer'][f'embed_{feat}']['embedding']
      g_tab = got['scorer'][f'embed_{feat}']['embedding']
      w_tab = want_params['scorer'][f'embed_{feat}']['embedding']
      moved = np.any(g_tab != old, axis=1)
      np.testing.assert_array_equal(moved, np.any(w_tab != old, axis=1))
      assert moved.any()
      # Rows no step touched keep their bits.
      np.testing.assert_array_equal(g_tab[~moved], old[~moved])
      for k in want_opt[path]:
        w = np.asarray(want_opt[path][k])
        scale = max(float(np.abs(w).max()), 1e-30)
        close(out['opt'][path][k], w, atol=1e-5 * scale, err_msg=k)
    assert int(out['opt']['count']) == int(want_opt['count']) == 2


@pytest.mark.parametrize('world', WORLDS)
def test_tensor_parallel_encoder_step_equals_jax_single_device(world_runs,
                                                              world):
  (_, _, _, want_loss, want), runs = case(world_runs, world, 'tp')
  for res in runs:
    plain, remat = res['tp'][False], res['tp'][True]
    # Heads (4) and mlp (32) divide model=2: every TP rule applies.
    assert any('query.kernel' in n for n in plain['sharded'])
    assert any('Dense_1.kernel' in n for n in plain['sharded'])
    assert 'scorer.encoder.token_embed.embedding' in plain['sharded']
    np.testing.assert_allclose(plain['loss'], want_loss, rtol=1e-5,
                               atol=1e-6)
    got = convert.to_flax({k: torch.from_numpy(v)
                           for k, v in plain['state'].items()})['params']
    # Attention logits are invariant to the key-projection bias (softmax
    # over keys removes a per-query constant): its true gradient is 0 and
    # Adam turns summation-order noise into arbitrary updates.
    assert_tree_close(got, want, atol=1e-5, skip=("'key']['bias'",))
    # Remat recomputes each block with the same inputs: bitwise.
    for k, v in plain['state'].items():
      np.testing.assert_array_equal(remat['state'][k], v, err_msg=k)
    # Clipped by the global norm over the shards: one process's step.
    clipped, one = res['tp']['clipped'], res['tp']['clipped_one']
    assert not any(np.array_equal(clipped['state'][k], v)
                   for k, v in plain['state'].items() if 'query' in k)
    for k, v in one['state'].items():
      if k.endswith(('key.bias', 'score.bias')):
        continue   # zero in theory, as above
      close(clipped['state'][k], v, atol=1e-5, err_msg=k)
