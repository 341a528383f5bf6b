"""The port's sparse embedding train step == the JAX package's, on the CPU.

``compact_unique``, ``pooled_lookup`` and the encoders, ``EmbeddingDNNScorer``
with its converter, ``LazyAdam`` / ``LazyAdagrad.update_rows``, the
``adagrad`` factory and ``make_sparse_train_step`` run in both packages on
the same numpy inputs and converted weights.

Tolerances. Integer outputs (``compact_unique``) and the set of rows a step
touches are equal exactly; rows no step touched keep their bits. Floats:
the forward and the slab gradients are float32 sums in another order (the
slab's backward adds token contributions in another order than XLA's
scatter-add), so values are held at rtol 1e-5 and an atol of 1e-5 of the
largest magnitude of the compared array. bfloat16 rows at 2^-7 of it (one
bf16 ulp, rounded up).

The dense Adam runs at eps 0.1 in both packages: the tower's output bias
has a true gradient of zero under the shift-invariant softmax loss, its
computed gradient is rounding noise (about 1e-6 here, a sum of O(1)
logit gradients), and at a small eps Adam turns that noise into moves of up
to a whole learning rate whose sign differs between any two
implementations (``tests/test_torch_train.py`` uses eps 1e-3 for the same
reason, against smaller noise). The tables keep LazyAdam's default eps:
their gradients are not zero in theory.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ranking_tpu import models as jax_models
from ranking_tpu import ops as jax_ops
from ranking_tpu import train as jax_train
from ranking_tpu.data.batch import batch_from_labels as jax_batch_from_labels
from ranking_tpu.models import embeddings as jax_emb
from ranking_tpu.train import sparse as jax_sparse
from ranking_tpu_torch import convert
from ranking_tpu_torch.data import batch as batch_lib
from ranking_tpu_torch.data import dataset
from ranking_tpu_torch.models import embeddings as emb
from ranking_tpu_torch.models import scorers
from ranking_tpu_torch.ops import loss_registry
from ranking_tpu_torch.ops.cuda import rows
from ranking_tpu_torch.train import sparse
from ranking_tpu_torch.train import state as state_lib
from ranking_tpu_torch.train import steps

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

VOCAB, DIM, B, L, T = 200, 8, 4, 6, 3
HIDDEN = (8, 4)
LR = 1e-2
DQ = 'scorer/embed_query_tokens/embedding'
DD = 'scorer/embed_document_tokens/embedding'


def _close(got, want, err_msg='', share=1e-5):
  got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
  scale = max(float(np.abs(want).max()), 1e-30)
  np.testing.assert_allclose(got, want, rtol=1e-5, atol=share * scale,
                             err_msg=err_msg)


# ------------------------------------------------------------ compact_unique


@pytest.mark.parametrize('seed,n,vocab,pad_frac', [
    (0, 64, 10, 0.2), (1, 256, 7, 0.0), (2, 37, 5, 0.5), (3, 16, 1, 0.3),
    (4, 128, 100000, 0.1), (5, 8, 3, 1.0), (6, 1, 4, 0.0)])
def test_compact_unique_equals_jax_bitwise(seed, n, vocab, pad_frac):
  rng = np.random.RandomState(seed)
  flat = rng.randint(0, vocab, size=n).astype(np.int32)
  pad = rng.rand(n) < pad_frac
  flat[pad] = -rng.randint(1, 5, size=n)[pad]
  want = jax.jit(jax_sparse.compact_unique)(jnp.asarray(flat))
  for fn in (sparse.compact_unique, sparse._compact_unique_reference):
    got = fn(torch.from_numpy(flat))
    for g, w, name in zip(got, want, ('uids', 'remap', 'filled')):
      assert g.dtype == (torch.bool if name == 'filled' else torch.int32)
      np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


# ---------------------------------------------------- lookup and the encoders


@pytest.mark.parametrize('combiner', ['mean', 'sum', 'sqrtn'])
def test_pooled_lookup_and_its_gradient_equal_jax(combiner):
  rng = np.random.RandomState(1)
  table = rng.randn(VOCAB, DIM).astype(np.float32)
  ids = rng.randint(-1, VOCAB + 20, size=(B, L, T)).astype(np.int32)
  ids[0, 0] = -1                       # a slot with no valid token
  ids[0, 1] = [VOCAB, VOCAB + 3, 5]    # clipped to the last row, counted
  cot = rng.randn(B, L, DIM).astype(np.float32)
  want, vjp = jax.vjp(lambda t: jax_emb.pooled_lookup(t, jnp.asarray(ids),
                                                      combiner),
                      jnp.asarray(table))
  t = torch.from_numpy(table).requires_grad_()
  got = emb.pooled_lookup(t, torch.from_numpy(ids), combiner)
  (got * torch.from_numpy(cot)).sum().backward()
  _close(got.detach(), want)
  _close(t.grad, vjp(jnp.asarray(cot))[0])
  with pytest.raises(ValueError, match='combiner'):
    emb.pooled_lookup(t, torch.from_numpy(ids), 'max')


def test_encoders_equal_jax_and_read_slabs_only_when_asked():
  rng = np.random.RandomState(2)
  ids = rng.randint(-1, 3 * VOCAB, size=(B, L, T)).astype(np.int32)
  table = rng.randn(VOCAB, DIM).astype(np.float32)
  for jcls, tcls in ((jax_emb.EmbeddingEncoder, emb.EmbeddingEncoder),
                     (jax_emb.HashEmbeddingEncoder, emb.HashEmbeddingEncoder)):
    want = jcls(VOCAB, DIM).apply({'params': {'embedding': table}},
                                  jnp.asarray(ids))
    enc = tcls(VOCAB, DIM)
    with torch.no_grad():
      enc.embedding.copy_(torch.from_numpy(table))
    _close(enc(torch.from_numpy(ids)).detach(), want)
    slab = torch.randn(5, DIM)
    slots = torch.tensor([[0, 4, -1]])
    with emb.read_from_slabs({enc: slab}):
      torch.testing.assert_close(enc(slots),
                                 emb.pooled_lookup(slab, slots))
    assert enc.slab is None
  init = emb.EmbeddingEncoder(VOCAB, 64, generator=torch.Generator()
                              .manual_seed(0)).embedding
  assert abs(init.std().item() - 1e-2) < 1e-3


def _jax_model(hidden=HIDDEN, use_batch_norm=False):
  return jax_models.RankingModel(scorer=jax_models.EmbeddingDNNScorer(
      hidden_layer_dims=hidden,
      vocab_sizes={'query_tokens': VOCAB, 'document_tokens': VOCAB},
      embedding_dim=DIM, dropout=0.0, use_batch_norm=use_batch_norm))


def _port_model(hidden=HIDDEN, use_batch_norm=False):
  return scorers.RankingModel(scorers.EmbeddingDNNScorer(
      hidden, vocab_sizes={'query_tokens': VOCAB, 'document_tokens': VOCAB},
      embedding_dim=DIM, dropout=0.0, use_batch_norm=use_batch_norm))


def _arrays(seed):
  """A ragged batch: padded documents (label -1), padded tokens (-1),
  graded labels, a list with no relevant document."""
  rng = np.random.RandomState(seed)
  labels = rng.randint(0, 5, size=(B, L)).astype(np.float32)
  labels[0, -2:] = -1.0
  labels[1, -1] = -1.0
  labels[2] = np.where(labels[2] >= 0, 0.0, -1.0)
  docs = rng.randint(0, VOCAB, size=(B, L, T)).astype(np.int32)
  docs[rng.rand(B, L, T) < 0.125] = -1
  query = rng.randint(0, VOCAB, size=(B, T)).astype(np.int32)
  query[rng.rand(B, T) < 0.125] = -1
  return labels, {'query_tokens': query}, {'document_tokens': docs}


def _randomized(params, seed):
  """Weights of scale 0.3, so that ReLU gates differ between documents."""
  rng = np.random.RandomState(seed)
  return jax.tree.map(
      lambda x: (rng.randn(*np.shape(x)) * 0.3).astype(np.float32), params)


def test_embedding_scorer_and_converter_equal_jax():
  labels, context, examples = _arrays(3)
  jbatch = jax_batch_from_labels(labels=labels, context=context,
                                 examples=examples)
  jmodel = _jax_model(use_batch_norm=True)
  variables = jax.tree.map(np.asarray, jmodel.init(
      jax.random.PRNGKey(0), jbatch.context, jbatch.examples, jbatch.mask))
  variables['params'] = _randomized(variables['params'], 4)
  want = jmodel.apply(variables, jbatch.context, jbatch.examples, jbatch.mask)
  tmodel = _port_model(use_batch_norm=True)
  state = convert.from_flax(variables)
  assert set(state) == set(tmodel.state_dict())
  tmodel.load_state_dict(state)
  tmodel.eval()
  tbatch = batch_lib.batch_from_labels(labels, context, examples)
  got = tmodel(tbatch.context, tbatch.examples, tbatch.mask)
  _close(got.detach(), want)
  back = convert.to_flax(tmodel.state_dict())
  jax.tree.map(np.testing.assert_array_equal, back, variables)
  # With a mesh (here one of one rank) the tables are row-sharded
  # encoders; on a model axis of one they hold the whole table and score
  # as the JAX model does.
  from ranking_tpu_torch import parallel
  sharded = scorers.RankingModel(scorers.EmbeddingDNNScorer(
      HIDDEN, vocab_sizes={'query_tokens': VOCAB, 'document_tokens': VOCAB},
      embedding_dim=DIM, dropout=0.0, use_batch_norm=True,
      mesh=parallel.make_mesh()))
  assert isinstance(sharded.scorer.embed_query_tokens,
                    parallel.ShardedEmbeddingEncoder)
  sharded.load_state_dict(state)
  sharded.eval()
  _close(sharded(tbatch.context, tbatch.examples, tbatch.mask).detach(), want)


# ---------------------------------------------------------- the optimizers


@pytest.mark.parametrize('kind', ['adam', 'adagrad'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('row_shape', [(DIM,), (2, DIM // 2)])
def test_update_rows_equals_jax(kind, dtype, row_shape):
  """Three updates of one table through ``update_rows`` with a callable
  learning rate (it must see the 0-based count) and slots that are filled
  but have a zero gradient. A bfloat16 table keeps its dtype; a table of
  three dims takes the same row update."""
  tdt, jdt = {'float32': (torch.float32, jnp.float32),
              'bfloat16': (torch.bfloat16, jnp.bfloat16)}[dtype]
  rng = np.random.RandomState(5)
  table = rng.randn(VOCAB, *row_shape).astype(np.float32)
  sched = lambda c: 1e-2 / (1.0 + c)  # noqa: E731
  jspec = (jax_sparse.LazyAdam(learning_rate=sched) if kind == 'adam'
           else jax_sparse.LazyAdagrad(learning_rate=sched))
  tspec = (sparse.LazyAdam(learning_rate=sched) if kind == 'adam'
           else sparse.LazyAdagrad(learning_rate=sched))
  jt = {'t': jnp.asarray(table).astype(jdt)}
  tt = {'t': torch.from_numpy(table).to(tdt)}
  jstate, tstate = jspec.init(jt), tspec.init(tt)
  frozen = tt['t'].clone()
  touched_rows = set()
  for i in range(3):
    uids = np.zeros(16, np.int32)
    uids[:12] = rng.permutation(VOCAB)[:12]
    filled = np.arange(16) < 12
    g = rng.randn(16, *row_shape).astype(np.float32)
    g[3] = 0.0                           # filled, not touched
    touched_rows |= set(uids[:12].tolist()) - {int(uids[3])}
    jt, jstate = jspec.update_rows(
        {'t': (jnp.asarray(uids), jnp.asarray(g).astype(jdt),
               jnp.asarray(filled))}, jstate, jt)
    tspec.update_rows({'t': (torch.from_numpy(uids),
                             torch.from_numpy(g).to(tdt),
                             torch.from_numpy(filled))}, tstate, tt)
  assert tt['t'].dtype == tdt
  got = convert.sparse_state_to_flax(tstate)
  assert int(got['count']) == int(jstate['count']) == 3
  # Only the JAX package's dense-gradient update writes `dropped`.
  assert int(got['dropped']) == int(jstate['dropped']) == 0
  share = 1e-5 if dtype == 'float32' else 2.0 ** -7
  _close(tt['t'].to(torch.float32), jt['t'].astype(jnp.float32),
         share=share)
  for name in got['t']:
    assert tstate['t'][name].dtype == tdt
    _close(got['t'][name], jstate['t'][name].astype(jnp.float32),
           err_msg=name, share=share)
  untouched = [r for r in range(VOCAB) if r not in touched_rows]
  assert torch.equal(tt['t'][untouched], frozen[untouched])


def test_adagrad_equals_optax_adagrad():
  rng = np.random.RandomState(6)
  params = {'w': rng.randn(5, 3).astype(np.float32),
            'b': rng.randn(3).astype(np.float32)}
  tx = optax.adagrad(0.1)
  jparams = jax.tree.map(jnp.asarray, params)
  opt_state = tx.init(jparams)
  tparams = [torch.from_numpy(params[k]).requires_grad_() for k in ('w', 'b')]
  opt = state_lib.adagrad(0.1)(tparams)
  for i in range(4):
    grads = {k: rng.randn(*v.shape).astype(np.float32)
             for k, v in params.items()}
    grads['b'][0] = 0.0                  # an entry that never moves
    updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads),
                                   opt_state)
    jparams = optax.apply_updates(jparams, updates)
    for p, k in zip(tparams, ('w', 'b')):
      p.grad = torch.from_numpy(grads[k])
    opt.step()
  for p, k in zip(tparams, ('w', 'b')):
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                               rtol=1e-6, atol=1e-7)


# --------------------------------------------------------- the sparse step


def _steps_both(kind, num_steps=2, jax_model=None, port_model=None,
                arrays=None, efs_jax=None, efs_port=None, variables=None):
  """``num_steps`` sparse steps of ``softmax_loss`` in both packages from
  the same weights on the same batches. Returns (jax state, port state,
  losses, the port's tables before the first step)."""
  arrays = arrays or [_arrays(10 + i) for i in range(num_steps)]
  labels, context, examples = arrays[0]
  jbatches = [jax_batch_from_labels(labels=a[0], context=a[1], examples=a[2])
              for a in arrays]
  tbatches = [dataset.flatten_examples(batch_lib.batch_from_labels(*a))
              for a in arrays]
  if kind == 'adam':
    jtx, ttx = optax.adam(LR, eps=0.1), state_lib.adam(LR, eps=0.1)
    jsp, tsp = jax_sparse.LazyAdam(LR), sparse.LazyAdam(LR)
  else:
    jtx, ttx = optax.adagrad(LR), state_lib.adagrad(LR)
    jsp, tsp = jax_sparse.LazyAdagrad(LR), sparse.LazyAdagrad(LR)
  jmodel = jax_model or _jax_model()
  jstate = jax_train.create_train_state(
      jmodel, jtx, jax.random.PRNGKey(0), jbatches[0].context,
      jbatches[0].examples, jbatches[0].mask, sparse_tx=jsp)
  if variables is None:
    variables = {'params': _randomized(jax.tree.map(np.asarray,
                                                    jstate.params), 7)}
  jstate = jstate.replace(params=variables['params'],
                          opt_state=jtx.init(jax_sparse.partition(
                              variables['params'], jsp)[0]))
  tmodel = port_model or _port_model()
  tmodel.load_state_dict(convert.from_flax(variables))
  tstate = state_lib.create_train_state(tmodel, ttx, device='cpu',
                                        sparse_tx=tsp)
  before = {k: v.detach().clone()
            for k, v in sparse.named_paths(tmodel).items() if tsp.matches(k)}
  efs_jax = efs_jax or jax_sparse.derive_embed_features(
      jstate.params, jbatches[0].context, jbatches[0].examples)
  efs_port = efs_port or sparse.derive_embed_features(
      sparse.named_paths(tmodel), tbatches[0].context,
      steps.restore_flat_examples(tbatches[0]).examples)
  assert [vars(e) for e in efs_port] == [vars(e) for e in efs_jax]
  loss = jax_ops.make_loss_fn(jax_ops.RankingLossKey.SOFTMAX_LOSS)
  jstep = jax.jit(jax_train.make_sparse_train_step(loss, efs_jax))
  tstep = steps.make_sparse_train_step(
      loss_registry.make_loss_fn('softmax_loss'), efs_port, device='cpu')
  losses = []
  for jb, tb in zip(jbatches, tbatches):
    jstate, jm = jstep(jstate, jb, jax.random.PRNGKey(1))
    tstate, tm = tstep(tstate, tb)
    losses.append((float(tm['loss']), float(jm['loss'])))
    for k in ('labels_mean', 'logits_mean'):
      _close(tm[k], jm[k], err_msg=k)
  return jstate, tstate, losses, before


def _assert_states_match(jstate, tstate, before):
  got = convert.to_flax(tstate.model.state_dict())['params']
  want = jax.tree.map(np.asarray, jstate.params)
  jax.tree_util.tree_map_with_path(
      lambda path, g, w: _close(g, w, err_msg=jax.tree_util.keystr(path)),
      got, want)
  after = sparse.named_paths(tstate.model)
  want_tables = dict(jax_sparse.partition(jstate.params,
                                          jstate.sparse_tx)[1])
  for path, old in before.items():
    moved = (after[path].detach() != old).any(dim=1).numpy()
    jmoved = np.any(np.asarray(want_tables[path]) != old.numpy(), axis=1)
    np.testing.assert_array_equal(moved, jmoved, err_msg=path)
    assert moved.any()
    # The lazy contract: rows no step touched keep their bits.
    assert torch.equal(after[path].detach()[~torch.from_numpy(moved)],
                       old[~torch.from_numpy(moved)])
  got_state = convert.sparse_state_to_flax(tstate.sparse_opt_state)
  want_state = jax.tree.map(np.asarray, jstate.sparse_opt_state)
  assert set(got_state) == set(want_state)
  assert int(got_state['count']) == int(want_state['count'])
  # Layout parity: only the dense-gradient update writes `dropped`.
  assert int(got_state['dropped']) == int(want_state['dropped']) == 0
  for path in before:
    for name, w in want_state[path].items():
      _close(got_state[path][name], w, err_msg=f'{path} {name}')


@pytest.mark.parametrize('kind', ['adam', 'adagrad'])
def test_sparse_step_equals_jax(kind):
  jstate, tstate, losses, before = _steps_both(kind)
  for got, want in losses:
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5)
  assert tstate.step == 2
  _assert_states_match(jstate, tstate, before)
  assert set(before) == {DQ, DD}


class _SharedScorer(torch.nn.Module):
  """One table fed by a context and an example feature."""

  def __init__(self):
    super().__init__()
    self.embed_shared = emb.EmbeddingEncoder(VOCAB, DIM)
    self.dnn = scorers.DNNScorer((8,), in_features=2 * DIM, dropout=0.0,
                                 use_batch_norm=False)

  def forward(self, context, examples, mask, training=False):
    d = self.embed_shared(examples['d_ids'])
    q = self.embed_shared(context['q_ids'])
    return self.dnn({}, {'d': d, 'q': q[:, None, :].expand(d.shape)}, mask,
                    training=training)


class _JaxSharedScorer(jax_models.scorers.nn.Module):

  @jax_models.scorers.nn.compact
  def __call__(self, context, examples, mask, training=False):
    enc = jax_emb.EmbeddingEncoder(vocab_size=VOCAB, embedding_dim=DIM,
                                   name='embed_shared')
    d = enc(examples['d_ids'])
    q = enc(context['q_ids'])
    return jax_models.DNNScorer(hidden_layer_dims=(8,), dropout=0.0,
                                use_batch_norm=False, name='dnn')(
        {}, {'d': d, 'q': jnp.broadcast_to(q[:, None, :], d.shape)}, mask,
        training=training)


class _HashScorer(torch.nn.Module):
  """A hash encoder of 16 buckets fed ids up to 200."""

  def __init__(self):
    super().__init__()
    self.embed_document_tokens = emb.HashEmbeddingEncoder(16, DIM)
    self.dnn = scorers.DNNScorer((8,), in_features=DIM, dropout=0.0,
                                 use_batch_norm=False)

  def forward(self, context, examples, mask, training=False):
    return self.dnn({}, {'emb': self.embed_document_tokens(
        examples['document_tokens'])}, mask, training=training)


class _JaxHashScorer(jax_models.scorers.nn.Module):

  @jax_models.scorers.nn.compact
  def __call__(self, context, examples, mask, training=False):
    e = jax_emb.HashEmbeddingEncoder(num_buckets=16, embedding_dim=DIM,
                                     name='embed_document_tokens')(
        examples['document_tokens'])
    return jax_models.DNNScorer(hidden_layer_dims=(8,), dropout=0.0,
                                use_batch_norm=False, name='dnn')(
        {}, {'emb': e}, mask, training=training)


def test_sparse_step_shared_table_and_hash_encoder_equal_jax():
  # Two features over one table: one dedup, one slab.
  arrays = []
  for i in range(2):
    labels, context, examples = _arrays(20 + i)
    arrays.append((labels,
                   {'q_ids': context['query_tokens'] % 64},
                   {'d_ids': examples['document_tokens'] % 64}))
  shared = [jax_sparse.EmbedFeature('scorer/embed_shared/embedding', 'q_ids',
                                    'context'),
            jax_sparse.EmbedFeature('scorer/embed_shared/embedding', 'd_ids',
                                    'examples')]
  jstate, tstate, losses, before = _steps_both(
      'adam', jax_model=jax_models.RankingModel(scorer=_JaxSharedScorer()),
      port_model=scorers.RankingModel(_SharedScorer()), arrays=arrays,
      efs_jax=shared, efs_port=[sparse.EmbedFeature(**vars(e))
                                for e in shared])
  for got, want in losses:
    np.testing.assert_allclose(got, want, rtol=1e-5)
  _assert_states_match(jstate, tstate, before)
  # A hash encoder: ids beyond its 16 buckets, reduced by the step to the
  # table's row count (no num_buckets declared).
  arrays = [(a[0], {}, {'document_tokens': a[2]['document_tokens']})
            for a in (_arrays(30), _arrays(31))]
  jstate, tstate, losses, before = _steps_both(
      'adagrad', jax_model=jax_models.RankingModel(scorer=_JaxHashScorer()),
      port_model=scorers.RankingModel(_HashScorer()), arrays=arrays)
  for got, want in losses:
    np.testing.assert_allclose(got, want, rtol=1e-5)
  _assert_states_match(jstate, tstate, before)


def _port_state(tsp=None, model=None):
  return state_lib.create_train_state(
      model or _port_model(), state_lib.adam(LR), device='cpu',
      sparse_tx=tsp or sparse.LazyAdam(LR))


def test_sparse_step_refuses_what_it_cannot_train():
  labels, context, examples = _arrays(40)
  batch = batch_lib.batch_from_labels(labels, context, examples)
  loss = loss_registry.make_loss_fn('softmax_loss')
  efs = sparse.derive_embed_features(sparse.named_paths(_port_model()),
                                     context, examples)
  assert [ef.param_path for ef in efs] == [DD, DQ]
  state = _port_state()
  with pytest.raises(ValueError, match='no declared id feature'):
    steps.make_sparse_train_step(loss, efs[:1], device='cpu')(state, batch)
  typo = efs + (sparse.EmbedFeature('scorer/embed_typo/embedding',
                                    'query_tokens', 'context'),)
  with pytest.raises(ValueError, match='match no sparse table'):
    steps.make_sparse_train_step(loss, typo, device='cpu')(state, batch)
  two_tables = (efs[0], sparse.EmbedFeature(DQ, 'document_tokens'))
  with pytest.raises(ValueError, match='feeds two sparse tables'):
    steps.make_sparse_train_step(loss, two_tables, device='cpu')(state, batch)
  with pytest.raises(ValueError, match='requires a TrainState'):
    steps.make_sparse_train_step(loss, efs, device='cpu')(
        state_lib.create_train_state(_port_model(), device='cpu'), batch)
  # The plain step trains such a state: the tables' dense gradients go to
  # the lazy update (held against the JAX package in
  # tests/test_torch_lazy_dense.py).
  steps.make_train_step(loss, device='cpu')(state, batch)
  assert int(state.sparse_opt_state['count']) == 1


def test_sparse_state_lives_beside_the_tables_and_bf16_tables_keep_dtype():
  labels, context, examples = _arrays(41)
  batch = dataset.flatten_examples(
      batch_lib.batch_from_labels(labels, context, examples))
  model = _port_model()
  model.scorer.embed_document_tokens.embedding.data = (
      model.scorer.embed_document_tokens.embedding.data.to(torch.bfloat16))
  state = _port_state(sparse.LazyAdagrad(LR), model)
  dense = list(state.optimizer.param_groups[0]['params'])
  assert all('embedding' not in n for n, p in model.named_parameters()
             if any(p is q for q in dense))
  assert len(dense) == len(list(model.parameters())) - 2
  acc = state.sparse_opt_state[DD]['acc']
  assert acc.dtype == torch.bfloat16 and acc.device == torch.device('cpu')
  table = model.scorer.embed_document_tokens.embedding
  old = table.detach().clone()
  efs = sparse.derive_embed_features(sparse.named_paths(model),
                                     batch.context, {'document_tokens': 0})
  step = steps.make_sparse_train_step(
      loss_registry.make_loss_fn('softmax_loss'), efs, device='cpu')
  state, metrics = step(state, batch)
  assert np.isfinite(float(metrics['loss']))
  assert table.dtype == torch.bfloat16 and acc.dtype == torch.bfloat16
  assert (table.detach() != old).any()
  assert rows.scatter_rows_multi.launches == 0   # the CPU computes plainly


def test_partition_and_merge_round_trip():
  params = sparse.named_paths(_port_model())
  dense, tables = sparse.partition(params, sparse.LazyAdam())
  assert set(tables) == {DQ, DD}
  assert all(dense[p] is None for p in tables)
  merged = sparse.merge(params, dense, tables)
  assert list(merged) == list(params)
  assert all(merged[k] is params[k] for k in params)
