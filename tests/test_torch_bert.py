"""The port's BERT inputs and TF-free checkpoint reader == the JAX package's.

``data/bert.py`` (``fuse_query_document_ids``, ``WordPieceTokenizer``,
``encode_query_documents``) on a vocabulary written here, with accents,
punctuation, CJK characters and ``##`` pieces; and
``models/bert_ckpt.py``, whose own reader of the TF2 tensor-bundle format
(no TensorFlow) must give every tensor that TensorFlow's reader gives, bit
for bit, and whose ``load_tf2_bert_checkpoint`` must equal the JAX
package's (which reads through TensorFlow) on a BERT-shaped checkpoint
written here by ``tf.raw_ops.SaveV2``, the loaded encoder's output the JAX
encoder's at rtol 1e-5, atol 1e-5. The checkpoint cases need TensorFlow to
write the files and skip without it.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from ranking_tpu.data import bert as jax_bert
from ranking_tpu_torch import convert
from ranking_tpu_torch.data import bert
from ranking_tpu_torch.models import bert_ckpt

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

VOCAB = ['[PAD]', '[UNK]', '[CLS]', '[SEP]', 'the', 'cafe', 'un', '##aff',
         '##able', 'aff', 'run', '##ning', '##s', 'hello', 'world', ',', '.',
         '!', '今', '天', 'a', 'b', 'c', 'naive', 'resume', '##e', '-', '?']
TEXTS = ['Hello, World!', 'The Café is naïve.', 'unaffable runnings',
         '今天 hello世界', 'résumé-a b?c', 'unzzz', '  ', 'foo_bar',
         'a' * 120, 'RUNNING, running; Run']


def test_fuse_query_document_ids_equals_jax():
  rng = np.random.RandomState(0)
  query = rng.randint(5, 30, size=(3, 5))
  query[0, 3:] = -1
  docs = rng.randint(5, 30, size=(3, 4, 9))
  docs[1, 2, 4:] = -1
  docs[2, 3] = -1
  for seq_len in (4, 9, 12, 20):
    got = bert.fuse_query_document_ids(query, docs, seq_len, 2, 3)
    want = jax_bert.fuse_query_document_ids(query, docs, seq_len, 2, 3)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('lowercase', [True, False])
def test_wordpiece_tokenizer_equals_jax(lowercase, tmp_path):
  path = tmp_path / 'vocab.txt'
  # CRLF lines and a blank line in the middle keep every id in place.
  path.write_bytes('\r\n'.join(VOCAB[:10] + [''] + VOCAB[10:]).encode()
                   + b'\r\n')
  tok = bert.WordPieceTokenizer(str(path), lowercase=lowercase)
  jtok = jax_bert.WordPieceTokenizer(str(path), lowercase=lowercase)
  assert tok.vocab == jtok.vocab
  for text in TEXTS:
    assert tok.tokenize(text) == jtok.tokenize(text), text
  assert tok.tokenize('unaffable') == [6, 7, 8]
  for a, b in zip(TEXTS, TEXTS[::-1]):
    for seq_len in (5, 8, 16):
      for got, want in zip(tok.encode_pair(a, b, seq_len),
                           jtok.encode_pair(a, b, seq_len)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
  for got, want in zip(
      bert.encode_query_documents(tok, 'hello cafe', TEXTS, 12),
      jax_bert.encode_query_documents(jtok, 'hello cafe', TEXTS, 12)):
    np.testing.assert_array_equal(got, want)
  for cls in (bert.WordPieceTokenizer, jax_bert.WordPieceTokenizer):
    with pytest.raises(ValueError, match=r'missing \[CLS\]'):
      cls([t for t in VOCAB if t != '[CLS]'])


# --- the checkpoint ---------------------------------------------------------

CFG = {'vocab_size': 30, 'hidden_size': 8, 'num_hidden_layers': 2,
       'num_attention_heads': 2, 'intermediate_size': 16,
       'max_position_embeddings': 12, 'type_vocab_size': 2,
       'hidden_dropout_prob': 0.0}


def _bert_variables(cfg, rng):
  """The official BertEncoder's variables (``model/...`` names without
  the attribute suffix) for ``cfg``, random values."""
  h, a, i = cfg['hidden_size'], cfg['num_attention_heads'], \
      cfg['intermediate_size']
  d = h // a
  shapes = {'layer_with_weights-0/embeddings': (cfg['vocab_size'], h),
            'layer_with_weights-1/embeddings':
                (cfg['max_position_embeddings'], h),
            'layer_with_weights-2/embeddings': (cfg['type_vocab_size'], h),
            'layer_with_weights-3/gamma': (h,),
            'layer_with_weights-3/beta': (h,)}
  for layer in range(cfg['num_hidden_layers']):
    base = f'layer_with_weights-{4 + layer}'
    for proj in ('query', 'key', 'value'):
      shapes[f'{base}/_attention_layer/_{proj}_dense/kernel'] = (h, a, d)
      shapes[f'{base}/_attention_layer/_{proj}_dense/bias'] = (a, d)
    shapes[f'{base}/_attention_output_dense/kernel'] = (a, d, h)
    shapes[f'{base}/_attention_output_dense/bias'] = (h,)
    for norm in ('_attention_layer_norm', '_output_layer_norm'):
      shapes[f'{base}/{norm}/gamma'] = (h,)
      shapes[f'{base}/{norm}/beta'] = (h,)
    shapes[f'{base}/_intermediate_dense/kernel'] = (h, i)
    shapes[f'{base}/_intermediate_dense/bias'] = (i,)
    shapes[f'{base}/_output_dense/kernel'] = (i, h)
    shapes[f'{base}/_output_dense/bias'] = (h,)
  pooler = f'layer_with_weights-{4 + cfg["num_hidden_layers"]}'
  shapes[f'{pooler}/kernel'] = (h, h)
  shapes[f'{pooler}/bias'] = (h,)
  return {k: (rng.randn(*s) * 0.5).astype(np.float32)
          for k, s in shapes.items()}


def _save(tf, prefix, tensors):
  names = sorted(tensors)
  tf.raw_ops.SaveV2(prefix=prefix, tensor_names=names,
                    shape_and_slices=[''] * len(names),
                    tensors=[tf.constant(tensors[n]) for n in names])


def _write_bert(tf, directory, variables, cfg=CFG):
  tensors = {f'model/{k}/.ATTRIBUTES/VARIABLE_VALUE': v
             for k, v in variables.items()}
  tensors['_CHECKPOINTABLE_OBJECT_GRAPH'] = np.array(b'\x0a\x02graph')
  tensors['save_counter/.ATTRIBUTES/VARIABLE_VALUE'] = np.int64(1)
  os.makedirs(directory, exist_ok=True)
  _save(tf, os.path.join(directory, 'ckpt-1'), tensors)
  config = os.path.join(directory, 'bert_config.json')
  with open(config, 'w') as f:
    json.dump(cfg, f)
  return os.path.join(directory, 'ckpt-1'), config


def test_reader_equals_tensorflow_s(tmp_path):
  """Every dtype the port reads, 160 more tensors (so that the index has
  several data blocks and restart points), names sharing long prefixes;
  and the directory form with a ``checkpoint`` file."""
  tf = pytest.importorskip('tensorflow')
  rng = np.random.RandomState(1)
  tensors = {
      'a/float32': rng.randn(3, 4).astype(np.float32),
      'a/float64': rng.randn(5).astype(np.float64),
      'a/int32': rng.randint(-9, 9, size=(2, 2)).astype(np.int32),
      'a/int64': rng.randint(-9, 9, size=(7,)).astype(np.int64),
      'a/bool': rng.rand(6) > 0.5,
      'a/float16': rng.randn(4).astype(np.float16),
      'a/scalar': np.float32(3.5),
      'a/empty': np.zeros((0, 3), np.float32),
      'a/string': np.array([b'x', b'yz']),
  }
  for i in range(160):
    tensors[f'model/layer_with_weights-{i % 7}/_dense_{i}/kernel'] = \
        rng.randn(i % 5 + 1).astype(np.float32)
  prefix = str(tmp_path / 'ckpt-3')
  _save(tf, prefix, tensors)
  (tmp_path / 'checkpoint').write_text(
      'model_checkpoint_path: "ckpt-3"\n'
      'all_model_checkpoint_paths: "ckpt-3"\n')
  bf16 = tf.cast(tf.constant(rng.randn(5).astype(np.float32)), tf.bfloat16)
  tf.raw_ops.SaveV2(prefix=str(tmp_path / 'bf16'), tensor_names=['b'],
                    shape_and_slices=[''], tensors=[bf16])
  reader = tf.train.load_checkpoint(prefix)
  for path in (prefix, str(tmp_path)):
    got = bert_ckpt.read_tf_checkpoint(path)
    assert set(got) == set(tensors) - {'a/string'}
    for name, value in got.items():
      want = reader.get_tensor(name)
      assert value.dtype == want.dtype and value.shape == want.shape, name
      np.testing.assert_array_equal(value, want)
  got = bert_ckpt.read_tf_checkpoint(str(tmp_path / 'bf16'))['b']
  np.testing.assert_array_equal(got, bf16.numpy().astype(np.float32))
  # A flipped byte of a tensor fails its CRC-32C.
  data = tmp_path / 'ckpt-3.data-00000-of-00001'
  raw = bytearray(data.read_bytes())
  raw[5] ^= 0x40
  data.write_bytes(bytes(raw))
  with pytest.raises(ValueError, match='CRC-32C'):
    bert_ckpt.read_tf_checkpoint(prefix)


def test_load_bert_checkpoint_equals_jax_bitwise(tmp_path):
  tf = pytest.importorskip('tensorflow')
  from ranking_tpu.models import bert_ckpt as jax_bert_ckpt
  variables = _bert_variables(CFG, np.random.RandomState(2))
  ckpt, config = _write_bert(tf, str(tmp_path), variables)
  jenc, jparams = jax_bert_ckpt.load_tf2_bert_checkpoint(ckpt, config)
  enc, params = bert_ckpt.load_tf2_bert_checkpoint(ckpt, config)
  assert (enc.vocab_size, enc.hidden_dim, enc.num_layers, enc.num_heads,
          enc.mlp_dim, enc.max_len, enc.type_vocab_size, enc.dropout) == (
              jenc.vocab_size, jenc.hidden_dim, jenc.num_layers,
              jenc.num_heads, jenc.mlp_dim, jenc.max_len,
              jenc.type_vocab_size, jenc.dropout)
  assert set(params) == set(enc.state_dict())
  jax.tree.map(np.testing.assert_array_equal,
               convert.to_flax(params)['params'],
               jax.tree.map(np.asarray, jparams))
  for name, value in enc.state_dict().items():
    assert torch.equal(value, params[name]), name
  rng = np.random.RandomState(3)
  ids = rng.randint(0, CFG['vocab_size'], size=(4, 10))
  attn = (rng.rand(4, 10) > 0.3).astype(np.int64)
  attn[:, 0] = 1
  segs = rng.randint(0, 2, size=(4, 10))
  want = jenc.apply({'params': jparams}, ids, segment_ids=segs,
                    attn_mask=attn)
  got = enc(torch.from_numpy(ids), segment_ids=torch.from_numpy(segs),
            attn_mask=torch.from_numpy(attn))
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                             rtol=1e-5, atol=1e-5)
  # The directory form reads the same.
  (tmp_path / 'checkpoint').write_text('model_checkpoint_path: "ckpt-1"\n')
  _, again = bert_ckpt.load_tf2_bert_checkpoint(str(tmp_path), config)
  assert all(torch.equal(again[n], params[n]) for n in params)


@pytest.mark.parametrize('fault, error, match', [
    ('missing', KeyError, 'checkpoint variable missing'),
    ('unmapped', ValueError, 'unmapped checkpoint variables'),
    ('shape', ValueError, r'shape \(30, 6\) != \(30, 8\)'),
])
def test_load_bert_checkpoint_refuses_as_jax_does(tmp_path, fault, error,
                                                  match):
  tf = pytest.importorskip('tensorflow')
  from ranking_tpu.models import bert_ckpt as jax_bert_ckpt
  variables = _bert_variables(CFG, np.random.RandomState(4))
  if fault == 'missing':
    del variables['layer_with_weights-5/_output_dense/bias']
  elif fault == 'unmapped':
    variables['layer_with_weights-9/kernel'] = np.ones(3, np.float32)
  else:
    variables['layer_with_weights-0/embeddings'] = np.ones((30, 6),
                                                           np.float32)
  ckpt, config = _write_bert(tf, str(tmp_path), variables)
  for load in (jax_bert_ckpt.load_tf2_bert_checkpoint,
               bert_ckpt.load_tf2_bert_checkpoint):
    with pytest.raises(error, match=match):
      load(ckpt, config)
