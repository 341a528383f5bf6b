"""The port's transformer encoder family == the JAX package's, on the CPU.

``TransformerEncoder`` and ``EncoderScorer`` (with and without segment
embeddings, ``input_mask`` and ``segment_ids``; a swapped-in encoder that
takes neither), their guards, ``remat``, ``warm_start_from``'s contract,
``convert``'s encoder tree both ways, and the sparse step's token-table
redirect. Each flax model is initialised, its parameters are randomised,
carried over with ``convert.from_flax``, and both packages run the same
numpy batch, at hidden 16, 2 heads, 2 layers, T = 8.

Tolerances: outputs rtol 1e-5, atol 1e-5 (float32 products summed in
another order); gradients at dropout 0 within 1e-4 of each leaf's largest
entry, or of the whole tree's for a leaf whose gradient is zero in theory
(an attention key bias: a constant of every logit of a query row, which
the softmax removes; the score bias under a loss that a shift of a list's
scores leaves unchanged). ``remat`` against the plain encoder, and the
sparse token step against the dense-gradient lazy step, bitwise: the same
operations on the same inputs.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from ranking_tpu import models as jax_models
from ranking_tpu import ops as jax_ops
from ranking_tpu.models import encoder as jax_encoder
from ranking_tpu_torch import convert
from ranking_tpu_torch.data import batch as batch_lib
from ranking_tpu_torch.data import dataset
from ranking_tpu_torch.models import embeddings as emb_lib
from ranking_tpu_torch.models import encoder
from ranking_tpu_torch.models import scorers
from ranking_tpu_torch.ops import loss_registry
from ranking_tpu_torch.train import sparse
from ranking_tpu_torch.train import state as state_lib
from ranking_tpu_torch.train import steps

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

V, H, HEADS, LAYERS, MLP, T = 50, 16, 2, 2, 32, 8
B, L = 3, 4
FWD = dict(rtol=1e-5, atol=1e-5)


def _features(seed=0, type_vocab=2):
  """ids with padding < 0 (one document all padding), BERT's input_mask
  (PAD id 0 a real entry, so ids stay >= 0 where it is given) and segment
  ids; labels with a padded document."""
  rng = np.random.RandomState(seed)
  ids = rng.randint(0, V, size=(B, L, T)).astype(np.int64)
  input_mask = (rng.rand(B, L, T) > 0.25).astype(np.int64)
  input_mask[..., 0] = 1
  input_mask[2, 3] = 0
  padded_ids = np.where(input_mask > 0, ids, -1)
  segs = rng.randint(0, max(type_vocab, 1), size=(B, L, T)).astype(np.int64)
  labels = rng.randint(0, 3, size=(B, L)).astype(np.float32)
  labels[1, -1] = -1.0
  return padded_ids, ids, input_mask, segs, labels


def _randomize(tree, rng):
  def leaf(path, x):
    name = jax.tree_util.keystr(path)
    x = np.asarray(x)
    if 'scale' in name:
      return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
    return (rng.randn(*x.shape) * 0.3).astype(np.float32)
  return jax.tree_util.tree_map_with_path(leaf, tree)


def _jax_encoder(type_vocab, dropout=0.0, remat=False):
  return jax_encoder.TransformerEncoder(
      vocab_size=V, hidden_dim=H, num_layers=LAYERS, num_heads=HEADS,
      mlp_dim=MLP, max_len=T, type_vocab_size=type_vocab, dropout=dropout,
      remat=remat)


def _port_encoder(type_vocab, dropout=0.0, remat=False, seed=0):
  return encoder.TransformerEncoder(
      V, H, LAYERS, HEADS, MLP, T, type_vocab_size=type_vocab,
      dropout=dropout, remat=remat,
      generator=torch.Generator().manual_seed(seed))


def _t(x):
  return torch.from_numpy(np.asarray(x))


def _close_tree(got, want, what, zero):
  flat = jax.tree_util.tree_flatten_with_path(want)[0]
  largest = max(float(np.abs(np.asarray(w)).max()) for _, w in flat)
  for path, w in flat:
    g = got
    for p in path:
      g = g[p.key]
    name = jax.tree_util.keystr(path)
    w, g = np.asarray(w), np.asarray(g)
    assert g.shape == w.shape, (what, name)
    scale = largest if zero(name) else float(np.abs(w).max())
    err = float(np.abs(g - w).max()) / max(scale, 1e-30)
    assert err <= 1e-4, (what, name, err)


@pytest.mark.parametrize('type_vocab, with_mask, with_segments', [
    (0, False, False), (0, True, False), (2, False, False),
    (2, True, True), (2, False, True), (1, True, False)])
def test_encoder_forward_equals_jax(type_vocab, with_mask, with_segments):
  padded_ids, ids, input_mask, segs, _ = _features(1, type_vocab)
  n = B * L
  args = {'ids': (ids if with_mask else padded_ids).reshape(n, T)}
  if with_mask:
    args['attn_mask'] = input_mask.reshape(n, T)
  if with_segments:
    args['segment_ids'] = segs.reshape(n, T)
  jenc = _jax_encoder(type_vocab)
  params = _randomize(jax.tree.map(np.asarray, jenc.init(
      jax.random.PRNGKey(0), **args)['params']), np.random.RandomState(2))
  want = jenc.apply({'params': params}, **args)
  tenc = _port_encoder(type_vocab)
  state = convert.from_flax({'params': params})
  assert set(state) == set(tenc.state_dict())
  tenc.load_state_dict(state)
  got = tenc(**{k: _t(v) for k, v in args.items()})
  assert got.shape == (n, H)
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
  back = convert.to_flax(tenc.state_dict())
  jax.tree.map(np.testing.assert_array_equal, back, {'params': params})


def _scorer_pair(type_vocab, dropout=0.0):
  jmodel = jax_models.RankingModel(scorer=jax_encoder.EncoderScorer(
      encoder=_jax_encoder(type_vocab, dropout), dropout=dropout))
  tmodel = scorers.RankingModel(encoder.EncoderScorer(
      _port_encoder(type_vocab, dropout), dropout=dropout))
  return jmodel, tmodel


@pytest.mark.parametrize('type_vocab, features', [
    (0, ('input_ids',)), (2, ('input_ids', 'input_mask', 'segment_ids'))])
def test_scorer_forward_and_gradients_equal_jax(type_vocab, features):
  padded_ids, ids, input_mask, segs, labels = _features(3, type_vocab)
  arrays = {'input_ids': ids if 'input_mask' in features else padded_ids,
            'input_mask': input_mask, 'segment_ids': segs}
  examples = {k: arrays[k] for k in features}
  mask = labels >= 0
  jmodel, tmodel = _scorer_pair(type_vocab)
  params = _randomize(jax.tree.map(np.asarray, jmodel.init(
      jax.random.PRNGKey(0), {}, examples, mask)['params']),
      np.random.RandomState(4))
  tmodel.load_state_dict(convert.from_flax({'params': params}))
  jloss = jax_ops.make_loss_fn(jax_ops.RankingLossKey.SOFTMAX_LOSS)
  tloss = loss_registry.make_loss_fn('softmax_loss')

  def f(p):
    logits = jmodel.apply({'params': p}, {}, examples, mask, training=True)
    return jloss(jnp.asarray(labels), logits), logits

  (want_loss, want_logits), want_grads = jax.value_and_grad(
      f, has_aux=True)(params)
  logits = tmodel({}, {k: _t(v) for k, v in examples.items()}, _t(mask),
                  training=True)
  loss = tloss(_t(labels), logits)
  loss.backward()
  np.testing.assert_allclose(logits.detach().numpy(),
                             np.asarray(want_logits), **FWD)
  assert np.all(logits.detach().numpy()[~mask] == np.float32(np.log(1e-10)))
  np.testing.assert_allclose(float(loss.detach()), float(want_loss), **FWD)
  grads = convert.to_flax({n: p.grad for n, p in tmodel.named_parameters()
                           if p.grad is not None})['params']
  _close_tree(grads, want_grads, 'gradients',
              lambda name: "['key']['bias']" in name
              or "['score']['bias']" in name)


def test_guards_raise_as_jax_s():
  ids = np.zeros((1, T + 1), np.int64)
  jenc, tenc = _jax_encoder(0), _port_encoder(0)
  params = jenc.init(jax.random.PRNGKey(0), ids[:, :T])
  for run in (lambda: jenc.apply(params, ids),
              lambda: tenc(_t(ids))):
    with pytest.raises(ValueError, match='exceeds max_len'):
      run()
  segs = np.zeros((1, T), np.int64)
  for run in (lambda: jenc.apply(params, ids[:, :T], segment_ids=segs),
              lambda: tenc(_t(ids[:, :T]), segment_ids=_t(segs))):
    with pytest.raises(ValueError, match='type_vocab_size is 0'):
      run()
  with pytest.raises(ValueError, match='torch.Generator'):
    _port_encoder(0, dropout=0.1)(_t(ids[:, :T]), training=True)


class _MeanPool(nn.Module):
  """A swapped-in encoder with the bare ``(ids, training) -> pooled``
  forward: it must be given neither attn_mask nor segment_ids."""

  hidden_dim = 4

  def __init__(self):
    super().__init__()
    self.table = nn.Parameter(torch.ones(V, 4))

  def forward(self, ids, training=False):
    return self.table[torch.clamp(ids, min=0)].mean(1)


def test_scorer_passes_features_only_to_an_encoder_that_takes_them():
  _, ids, input_mask, segs, labels = _features(5)
  model = encoder.EncoderScorer(_MeanPool(), dropout=0.0)
  out = model({}, {'input_ids': _t(ids), 'input_mask': _t(input_mask),
                   'segment_ids': _t(segs)}, _t(labels >= 0))
  assert out.shape == (B, L)
  with pytest.raises(ValueError, match='hidden_dim'):
    encoder.EncoderScorer(nn.Identity())


def test_remat_equals_plain_bitwise_at_dropout():
  padded_ids, ids, input_mask, segs, _ = _features(6)
  args = dict(ids=_t(ids.reshape(-1, T)),
              attn_mask=_t(input_mask.reshape(-1, T)),
              segment_ids=_t(segs.reshape(-1, T)))

  def run(remat):
    enc = _port_encoder(2, dropout=0.1, remat=remat, seed=7)
    out = enc(training=True, generator=torch.Generator().manual_seed(3),
              **args)
    torch.sum(out ** 2).backward()
    with torch.no_grad():
      evaluated = enc(**args)
    return out.detach(), evaluated, {n: p.grad for n, p in
                                     enc.named_parameters()}

  out_plain, eval_plain, g_plain = run(False)
  out_remat, eval_remat, g_remat = run(True)
  assert torch.equal(out_remat, out_plain)
  assert torch.equal(eval_remat, eval_plain)
  assert g_plain.keys() == g_remat.keys()
  for name in g_plain:
    assert torch.equal(g_remat[name], g_plain[name]), name
  # Dropout was on: another generator seed gives another output.
  enc = _port_encoder(2, dropout=0.1, seed=7)
  other = enc(training=True, generator=torch.Generator().manual_seed(4),
              **args)
  assert not torch.equal(other.detach(), out_plain)


def _params_pair():
  """A flax scorer's parameters and the same as the port's names."""
  _, ids, input_mask, segs, labels = _features(8)
  jmodel, tmodel = _scorer_pair(2)
  examples = {'input_ids': ids}
  params = jax.tree.map(np.asarray, jmodel.init(
      jax.random.PRNGKey(0), {}, examples, labels >= 0)['params'])
  tmodel.load_state_dict(convert.from_flax({'params': params}))
  return params, dict(tmodel.state_dict())


@pytest.mark.parametrize('case', ['suffix', 'longest', 'boundary', 'shape'])
def test_warm_start_contract_equals_jax(case):
  params, named = _params_pair()
  ln = np.full((H,), 2.0, np.float32)
  pretrained = {
      # Every encoder's token table, by its suffix.
      'suffix': {'token_embed/embedding': np.full((V, H), 0.5, np.float32)},
      # The longer name wins over the shorter for the block's norm; the
      # embedding's LayerNorm_0 takes the shorter one.
      'longest': {'LayerNorm_0/scale': ln,
                  'block_1/LayerNorm_0/scale': ln * 3},
      # 'm_embed/embedding' is a suffix of 'token_embed/embedding' as a
      # string, not at a path boundary: it matches nothing.
      'boundary': {'m_embed/embedding': np.ones((V, H), np.float32),
                   'pooler/bias': np.full((H,), -1.0, np.float32)},
      # A shape that disagrees keeps the fresh parameter.
      'shape': {'token_embed/embedding': np.ones((V + 1, H), np.float32),
                'score/kernel': np.full((H, 1), 0.25, np.float32)},
  }[case]
  want = jax.tree.map(np.asarray, jax_encoder.warm_start_from(
      params, pretrained))
  got = encoder.warm_start_from(named, pretrained)
  assert got.keys() == named.keys()
  back = convert.to_flax(got)['params']
  jax.tree.map(np.testing.assert_array_equal, back, want)
  moved = sum(not torch.equal(got[n], named[n]) for n in named)
  assert moved == {'suffix': 1, 'longest': 3, 'boundary': 1,
                   'shape': 1}[case]
  unused = {'suffix': False, 'longest': False, 'boundary': True,
            'shape': True}[case]
  for strict_fn in (lambda: jax_encoder.warm_start_from(
                        params, pretrained, strict=True),
                    lambda: encoder.warm_start_from(named, pretrained,
                                                    strict=True)):
    if unused:
      with pytest.raises(ValueError, match='unused pretrained entries'):
        strict_fn()
    else:
      strict_fn()


def test_sparse_token_step_equals_dense_lazy_step_bitwise():
  """The encoder's token table trains sparsely, its lookup redirected onto
  the row slab: bitwise the dense-gradient lazy path over 3 steps (the
  position and segment tables stay dense through table_pattern)."""
  rng = np.random.RandomState(11)
  b, l, s, v = 3, 4, 8, 64
  labels = rng.randint(0, 3, size=(b, l)).astype(np.float32)
  ids = rng.randint(0, v, size=(b, l, s)).astype(np.int64)
  masks = (rng.rand(b, l, s) > 0.2).astype(np.int64)
  segs = rng.randint(0, 2, size=(b, l, s)).astype(np.int64)
  batch = dataset.flatten_examples(batch_lib.batch_from_labels(
      labels, examples={'input_ids': ids, 'input_mask': masks,
                        'segment_ids': segs}))

  def mkstate():
    model = scorers.RankingModel(encoder.EncoderScorer(
        encoder.TransformerEncoder(
            v, 8, 1, 2, 16, s, type_vocab_size=2, dropout=0.0,
            generator=torch.Generator().manual_seed(0)), dropout=0.0))
    return state_lib.create_train_state(
        model, state_lib.adam(1e-2), device='cpu',
        sparse_tx=sparse.LazyAdam(learning_rate=1e-2,
                                  table_pattern=r'token_embed/embedding'))

  dense_state, sparse_state = mkstate(), mkstate()
  restored = steps.restore_flat_examples(batch)
  efs = sparse.derive_embed_features(
      sparse.named_paths(sparse_state.model), restored.context,
      restored.examples, table_pattern=r'token_embed/embedding')
  assert [ef.feature for ef in efs] == ['input_ids']
  assert efs[0].param_path == 'scorer/encoder/token_embed/embedding'
  loss_fn = loss_registry.make_loss_fn('softmax_loss')
  dstep = steps.make_train_step(loss_fn, device='cpu')
  sstep = steps.make_sparse_train_step(loss_fn, efs, device='cpu')
  table = sparse_state.model.scorer.encoder.token_embed.embedding
  before = table.detach().clone()
  for _ in range(3):
    dense_state, dm = dstep(dense_state, batch)
    sparse_state, sm = sstep(sparse_state, batch)
    assert torch.equal(dm['loss'], sm['loss'])
    assert table.grad is None          # the dense table gradient never exists
  for (name, a), (_, c) in zip(dense_state.model.state_dict().items(),
                               sparse_state.model.state_dict().items()):
    assert torch.equal(a, c), name
  for key in ('m', 'v'):
    assert torch.equal(
        dense_state.sparse_opt_state[efs[0].param_path][key],
        sparse_state.sparse_opt_state[efs[0].param_path][key])
  untouched = np.ones(v, bool)
  untouched[np.unique(ids[(masks > 0) & (labels >= 0)[..., None]])] = False
  assert untouched.any()
  assert torch.equal(table.detach()[untouched], before[untouched])
  # A lazy pattern that also takes the position table leaves it with no
  # id feature: the sparse step refuses it.
  with pytest.raises(ValueError, match='no declared id feature'):
    state = mkstate()
    state = state_lib.create_train_state(
        state.model, state_lib.adam(1e-2), device='cpu',
        sparse_tx=sparse.LazyAdam(table_pattern=r'embedding'))
    sstep(state, batch)


@pytest.mark.parametrize('rows', [4, 12])
def test_embed_reads_as_jnp_take(rows):
  """Ids past the table read NaN rows (jnp.take's fill), negative ids
  count from the end, a table of one row broadcasts; a small table (read
  by selection) and a larger one (a gather) alike, with the gradient of
  the gather's."""
  table = np.arange(rows * 3, dtype=np.float32).reshape(rows, 3)
  ids = np.array([[0, rows - 1, -1, rows, -rows - 1, 2, 2]])
  embed = emb_lib.Embed(rows, 3)
  with torch.no_grad():
    embed.embedding.copy_(_t(table))
  out = embed(_t(ids))
  want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0))
  np.testing.assert_array_equal(out.detach().numpy(), want)
  up = torch.arange(21, dtype=torch.float32).reshape(1, 7, 3)
  torch.sum(torch.nan_to_num(out) * up).backward()
  gather = torch.zeros(rows, 3).index_add_(
      0, _t(np.array([0, rows - 1, rows - 1, 2, 2])), up[0, [0, 1, 2, 5, 6]])
  np.testing.assert_array_equal(embed.embedding.grad.numpy(),
                                gather.numpy())
  one = emb_lib.Embed(1, 3)
  assert one(_t(ids)).shape == (1, 7, 3)

