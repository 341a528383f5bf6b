"""The port's dense-gradient lazy update == the JAX package's, on the CPU.

``LazyAdam.update`` and ``LazyAdagrad.update`` (the compaction of the
touched rows into ``max_rows`` slots, the step, the write, the ``dropped``
counter), ``TrainState.apply_gradients`` through ``make_train_step`` on a
state with a ``sparse_tx``, a checkpoint round trip, and ``SimplePipeline``
with ``optimizer='lazy_adam'`` on an antique-style model whose tables
(``embed_q``, ``embed_d``) no batch feature names, so that both pipelines
fall back from the sparse step to this path.

Tolerances. The updates on equal gradients: within 1e-6 of each array's
largest magnitude (float32 Adam and Adagrad arithmetic, the same
operations in another library); the rows that no step touched and the
rows a full buffer dropped keep their bits; ``dropped`` and ``count``
exactly. The train steps and the pipeline: the forward and the gradients
are float32 sums in another order, so values at rtol 1e-5 and 1e-5 of the
largest magnitude (the steps), and per-epoch metrics at rtol 1e-4 (the
pipeline, as ``tests/test_torch_pipeline.py``). Both train under the mean
squared loss, with the optimizers' default eps: under a loss that a shift
of every score of a list leaves unchanged (softmax), a query token's row
can have a gradient of zero in theory (every document of its list in the
same ReLU region), which is rounding noise that Adam at eps 1e-8 turns
into a step of up to the whole rate, in directions that differ between
any two implementations.
"""

import json
import os

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from ranking_tpu import models as jax_models
from ranking_tpu import ops as jax_ops
from ranking_tpu import train as jax_train
from ranking_tpu.data.batch import batch_from_labels as jax_batch_from_labels
from ranking_tpu.models import embeddings as jax_emb
from ranking_tpu.pipeline import hparams as jax_hparams
from ranking_tpu.pipeline import pipeline as jax_pipeline
from ranking_tpu.train import sparse as jax_sparse
from ranking_tpu_torch import convert
from ranking_tpu_torch.data import batch as batch_lib
from ranking_tpu_torch.data import dataset
from ranking_tpu_torch.models import embeddings as emb
from ranking_tpu_torch.models import scorers
from ranking_tpu_torch.ops import loss_registry
from ranking_tpu_torch.pipeline import hparams as hparams_lib
from ranking_tpu_torch.pipeline import pipeline
from ranking_tpu_torch.train import checkpoint
from ranking_tpu_torch.train import sparse
from ranking_tpu_torch.train import state as state_lib
from ranking_tpu_torch.train import steps

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

VOCAB, DIM, B, L, TQ, TD = 40, 4, 4, 6, 3, 4
HIDDEN = (8,)
LR = 0.05
DQ, DD = 'scorer/embed_q/embedding', 'scorer/embed_d/embedding'


def _close(got, want, share, err_msg=''):
  got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
  scale = max(float(np.abs(want).max()), 1e-30)
  np.testing.assert_allclose(got, want, rtol=share, atol=share * scale,
                             err_msg=err_msg)


# ---------------------------------------------------------------- the updates

def _optimizers(kind, max_rows):
  if kind == 'adam':
    return (jax_sparse.LazyAdam(LR, max_rows=max_rows),
            sparse.LazyAdam(LR, max_rows=max_rows))
  return (jax_sparse.LazyAdagrad(LR, max_rows=max_rows),
          sparse.LazyAdagrad(LR, max_rows=max_rows))


def _grads(rng, tables, touched_share):
  """Dense gradients with whole rows of zeros (untouched rows)."""
  out = {}
  for p, t in tables.items():
    g = rng.randn(*t.shape).astype(np.float32)
    rows = rng.rand(t.shape[0]) < touched_share
    g[~rows] = 0.0
    out[p] = g
  return out


@pytest.mark.parametrize('kind', ['adam', 'adagrad'])
@pytest.mark.parametrize('max_rows', [64, 5])
def test_lazy_update_equals_jax(kind, max_rows):
  """Three steps on two tables (one [V, a, b]); ``max_rows`` 64 holds every
  touched row, 5 drops some every step."""
  rng = np.random.RandomState(0)
  tables = {'t/embedding': rng.randn(VOCAB, DIM).astype(np.float32),
            'u/embedding': rng.randn(12, 2, 3).astype(np.float32)}
  jopt, topt = _optimizers(kind, max_rows)
  jstate = jopt.init({p: jnp.asarray(t) for p, t in tables.items()})
  jparams = {p: jnp.asarray(t) for p, t in tables.items()}
  tparams = {p: torch.from_numpy(t.copy()) for p, t in tables.items()}
  tstate = topt.init(tparams)
  jupdate = jax.jit(jopt.update)
  for _ in range(3):
    grads = _grads(rng, tables, 0.4)
    before = {p: t.clone() for p, t in tparams.items()}
    moments = {p: {k: v.clone() for k, v in tstate[p].items()}
               for p in tables}
    jparams, jstate = jupdate({p: jnp.asarray(g) for p, g in grads.items()},
                              jstate, jparams)
    tparams, tstate = topt.update(
        {p: torch.from_numpy(g) for p, g in grads.items()}, tstate, tparams)
    for p in tables:
      _close(tparams[p], jparams[p], 1e-6, p)
      for k in tstate[p]:
        _close(tstate[p][k], jstate[p][k], 1e-6, f'{p} {k}')
      # Rows with a zero gradient, and rows a full buffer dropped, keep
      # their bits in the table and its moments.
      flat = grads[p].reshape(grads[p].shape[0], -1)
      touched = np.flatnonzero(np.abs(flat).sum(1) > 0)
      stepped = np.zeros(flat.shape[0], bool)
      stepped[touched[:max_rows]] = True
      assert torch.equal(tparams[p][~stepped], before[p][~stepped])
      for k in tstate[p]:
        assert torch.equal(tstate[p][k][~stepped], moments[p][k][~stepped])
    assert int(tstate['count']) == int(jstate['count'])
    assert int(tstate['dropped']) == int(jstate['dropped'])
  if max_rows == 5:
    assert int(tstate['dropped']) > 0


def test_compaction_counts_the_overflow_exactly():
  g = torch.zeros(10, 3)
  rows = [1, 2, 4, 7, 9]
  g[rows] = 1.0
  idx, filled, dropped = sparse._compact_touched_rows(g, 3, 10)
  assert idx.tolist() == [1, 2, 4] and filled.tolist() == [True] * 3
  assert int(dropped) == 2 and dropped.dtype == torch.int32
  idx, filled, dropped = sparse._compact_touched_rows(g, 8, 10)
  assert idx[:5].tolist() == rows and filled.tolist() == [True] * 5 + [False] * 3
  assert int(dropped) == 0
  # Nothing touched: no slot filled, and the write changes nothing.
  table = torch.randn(10, 3)
  idx, filled, _ = sparse._compact_touched_rows(torch.zeros(10, 3), 4, 10)
  before = table.clone()
  sparse._write_compacted((table,), idx, filled, (table[idx] + 1.0,))
  assert not filled.any() and torch.equal(table, before)


# ------------------------------------------------------------ the train step

class _JaxAntique(flax_nn.Module):
  """antique_din.py's shape: token tables named embed_q and embed_d, which
  match no batch feature, under a DNN tower (dropout 0)."""

  @flax_nn.compact
  def __call__(self, context, examples, mask, training=False):
    ctx = {'q': jax_emb.EmbeddingEncoder(VOCAB, DIM, name='embed_q')(
        context['query_tokens'])}
    exs = {'d': jax_emb.EmbeddingEncoder(VOCAB, DIM, name='embed_d')(
        examples['document_tokens'])}
    return jax_models.DNNScorer(hidden_layer_dims=HIDDEN, dropout=0.0,
                                use_batch_norm=False, name='dnn')(
                                    ctx, exs, mask, training=training)


class _Antique(nn.Module):

  def __init__(self):
    super().__init__()
    self.embed_q = emb.EmbeddingEncoder(VOCAB, DIM)
    self.embed_d = emb.EmbeddingEncoder(VOCAB, DIM)
    self.dnn = scorers.DNNScorer(HIDDEN, in_features=2 * DIM, dropout=0.0,
                                 use_batch_norm=False)

  def forward(self, context, examples, mask, training=False, generator=None):
    return self.dnn({'q': self.embed_q(context['query_tokens'])},
                    {'d': self.embed_d(examples['document_tokens'])}, mask,
                    training=training)


def _arrays(seed, n=B):
  """Ragged lists of token ids (padding -1) over a small vocabulary, so
  that lists share rows."""
  rng = np.random.RandomState(seed)
  labels = rng.randint(0, 5, size=(n, L)).astype(np.float32)
  labels[:, -1] = -1.0
  labels[0, -3:] = -1.0
  docs = rng.randint(0, VOCAB, size=(n, L, TD)).astype(np.int32)
  docs[rng.rand(n, L, TD) < 0.2] = -1
  query = rng.randint(0, VOCAB, size=(n, TQ)).astype(np.int32)
  query[rng.rand(n, TQ) < 0.2] = -1
  return labels, {'query_tokens': query}, {'document_tokens': docs}


def _init(seed=0):
  labels, context, examples = _arrays(100)
  jmodel = jax_models.RankingModel(scorer=_JaxAntique())
  variables = jmodel.init(jax.random.PRNGKey(seed), context, examples,
                          labels >= 0, training=False)
  rng = np.random.RandomState(seed + 1)
  params = jax.tree.map(
      lambda x: (rng.randn(*np.shape(x)) * 0.3).astype(np.float32),
      dict(variables)['params'])
  return jmodel, params


@pytest.mark.parametrize('kind,max_rows', [('adam', 8192), ('adagrad', 8192),
                                           ('adam', 6)])
def test_train_step_dense_lazy_equals_jax(kind, max_rows):
  """Three plain train steps on a state whose tables no feature names:
  the dense optimizer steps the tower, the lazy update the tables."""
  jmodel, params = _init()
  jsp, tsp = _optimizers(kind, max_rows)
  jtx, ttx = ((optax.adam(LR), state_lib.adam(LR))
              if kind == 'adam' else
              (optax.adagrad(LR), state_lib.adagrad(LR)))
  arrays = [_arrays(10 + i) for i in range(3)]
  jbatches = [jax_batch_from_labels(labels=a[0], context=a[1], examples=a[2])
              for a in arrays]
  jstate = jax_train.create_train_state(
      jmodel, jtx, jax.random.PRNGKey(0), jbatches[0].context,
      jbatches[0].examples, jbatches[0].mask, sparse_tx=jsp)
  jstate = jstate.replace(params=params, opt_state=jtx.init(
      jax_sparse.partition(params, jsp)[0]))
  tmodel = scorers.RankingModel(_Antique())
  tmodel.load_state_dict(convert.from_flax({'params': params}))
  tstate = state_lib.create_train_state(tmodel, ttx, device='cpu',
                                        sparse_tx=tsp)
  assert sorted(sparse.partition(sparse.named_paths(tmodel), tsp)[1]) == [
      DD, DQ]
  assert sparse.derive_embed_features(
      sparse.named_paths(tmodel), arrays[0][1], arrays[0][2]) == ()
  before = {p: t.detach().clone() for p, t in
            sparse.named_paths(tmodel).items() if tsp.matches(p)}
  loss = jax_ops.make_loss_fn(jax_ops.RankingLossKey.MEAN_SQUARED_LOSS)
  jstep = jax.jit(jax_train.make_train_step(loss))
  tstep = steps.make_train_step(
      loss_registry.make_loss_fn('mean_squared_loss'), device='cpu')
  touched = {p: set() for p in before}
  for a, jb in zip(arrays, jbatches):
    jstate, jm = jstep(jstate, jb, jax.random.PRNGKey(1))
    tstate, tm = tstep(tstate, dataset.flatten_examples(
        batch_lib.batch_from_labels(*a)))
    _close(tm['loss'], jm['loss'], 1e-5, 'loss')
    touched[DQ] |= set(a[1]['query_tokens'][a[1]['query_tokens'] >= 0])
    touched[DD] |= set(a[2]['document_tokens'][
        (a[2]['document_tokens'] >= 0) & (a[0] >= 0)[..., None]])
  got = convert.to_flax(tstate.model.state_dict())['params']
  jax.tree_util.tree_map_with_path(
      lambda path, g, w: _close(g, w, 1e-5, jax.tree_util.keystr(path)),
      got, jax.tree.map(np.asarray, jstate.params))
  for p in before:
    for k, v in tstate.sparse_opt_state[p].items():
      _close(v, jstate.sparse_opt_state[p][k], 1e-5, f'{p} {k}')
    untouched = np.ones(VOCAB, bool)
    untouched[sorted(touched[p])] = False
    table = sparse.named_paths(tstate.model)[p].detach()
    assert torch.equal(table[untouched], before[p][untouched])
  for k in ('count', 'dropped'):
    assert int(tstate.sparse_opt_state[k]) == int(jstate.sparse_opt_state[k])
  if max_rows == 6:
    assert int(tstate.sparse_opt_state['dropped']) > 0


def test_checkpoint_round_trip_keeps_dropped_and_moments(tmp_path):
  _, params = _init()
  arrays = _arrays(20)

  def fresh():
    model = scorers.RankingModel(_Antique())
    model.load_state_dict(convert.from_flax({'params': params}))
    return state_lib.create_train_state(
        model, state_lib.adam(LR), device='cpu',
        sparse_tx=sparse.LazyAdam(LR, max_rows=4))

  state = fresh()
  step = steps.make_train_step(loss_registry.make_loss_fn('softmax_loss'),
                               device='cpu')
  state, _ = step(state, batch_lib.batch_from_labels(*arrays))
  assert int(state.sparse_opt_state['dropped']) > 0
  manager = checkpoint.CheckpointManager(str(tmp_path / 'ckpt'))
  manager.save(state, {'loss': 1.0})
  restored = manager.restore(fresh())
  assert restored.step == 1
  for p, value in state.sparse_opt_state.items():
    got = restored.sparse_opt_state[p]
    if isinstance(value, dict):
      for k in value:
        assert torch.equal(got[k], value[k])
    else:
      assert torch.equal(got, value)
  exported = convert.sparse_state_to_flax(restored.sparse_opt_state)
  assert exported['dropped'] == int(state.sparse_opt_state['dropped'])
  assert exported['dropped'].dtype == np.int32


# -------------------------------------------------------------- the pipeline

RUN = dict(num_epochs=1, steps_per_epoch=3, validation_steps=100,
           learning_rate=LR, loss='mean_squared_loss',
           steps_per_execution=1,
           optimizer='lazy_adam')


class _Builder:
  """In-memory token lists as either package's batches
  (``batch_from_labels``); the train stream repeats, the validation stream
  is one pass."""

  def __init__(self, batch_from_labels):
    self.batch_from_labels = batch_from_labels
    self.train = [_arrays(30 + i) for i in range(3)]
    self.valid = [_arrays(40 + i) for i in range(2)]

  def _batch(self, a):
    return self.batch_from_labels(*a)

  def train_batches(self):
    while True:
      for a in self.train:
        yield self._batch(a)

  def valid_batches(self):
    return iter([self._batch(a) for a in self.valid])


def _jax_batch(labels, context, examples):
  return jax_batch_from_labels(labels=labels, context=context,
                               examples=examples)


def test_pipeline_lazy_adam_without_named_tables_equals_jax(tmp_path):
  jmodel, _ = _init()
  jdir = str(tmp_path / 'jax')
  jhp = jax_hparams.PipelineHparams(model_dir=jdir, mesh_data=1, **RUN)
  jpipe = jax_pipeline.SimplePipeline(jmodel, _Builder(_jax_batch), jhp)
  # The JAX pipeline initialises its own weights: start both from the
  # same ones by handing the port the JAX run's initial state.
  first = next(_Builder(_jax_batch).train_batches())
  initial = jax_train.create_train_state(
      jmodel, optax.adam(LR), jax.random.PRNGKey(jhp.seed), first.context,
      first.examples, first.mask)
  jpipe.train_and_validate()
  tmodel = scorers.RankingModel(_Antique())
  tmodel.load_state_dict(convert.from_flax(
      jax.tree.map(np.asarray, {'params': initial.params})))
  tdir = str(tmp_path / 'port')
  tpipe = pipeline.SimplePipeline(
      tmodel, _Builder(batch_lib.batch_from_labels),
      hparams_lib.PipelineHparams(model_dir=tdir, **RUN), device='cpu')
  tpipe.train_and_validate()
  logs = []
  for d in (jdir, tdir):
    with open(os.path.join(d, 'metrics.jsonl')) as f:
      logs.append([json.loads(line) for line in f])
  assert len(logs[0]) == len(logs[1]) == 1
  for name in ('loss', 'val_loss', 'ndcg@1', 'ndcg@5', 'ndcg'):
    np.testing.assert_allclose(logs[1][0][name], logs[0][0][name],
                               rtol=1e-4, err_msg=name)
  state = tpipe.final_state
  assert isinstance(state.sparse_tx, sparse.LazyAdam)
  assert int(state.sparse_opt_state['count']) == 3
  assert int(state.sparse_opt_state['dropped']) == 0
  got = convert.to_flax(state.model.state_dict())['params']['scorer']
  want = jax.tree.map(np.asarray, jpipe.final_state.params)['scorer']
  for name in ('embed_q', 'embed_d'):
    _close(got[name]['embedding'], want[name]['embedding'], 1e-3, name)
