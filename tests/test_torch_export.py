"""The port's serving artifact == the JAX package's, on the CPU.

``export_predictor`` / ``load_predictor`` of the port run on
``convert.from_flax`` weights beside the JAX package's on the same
flax variables and the same serialized requests: ``predict``, ``regress``
and ``score_batch`` agree to 1e-5 (float32 forwards summed in another
order), float32 and int8. The int8 values and scales are bit-equal to the
JAX package's in the flax layout (the same numpy arithmetic on the same
float32 weights); the manifests' spec JSON is equal. An artifact loads in a
fresh process where ``ranking_tpu_torch.models`` cannot be imported, and
bfloat16 leaves round-trip without ``ml_dtypes``. Every raise of the JAX
export has its counterpart.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ranking_tpu import models as jax_models
from ranking_tpu.data import parsers as jax_parsers
from ranking_tpu.data.batch import RankingBatch as JaxBatch
from ranking_tpu.pipeline import export as jax_export
from ranking_tpu_torch import convert
from ranking_tpu_torch.data import batch as batch_lib
from ranking_tpu_torch.data import parsers
from ranking_tpu_torch.data import proto
from ranking_tpu_torch.models import scorers
from ranking_tpu_torch.pipeline import export

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

# Widths at which int8 engages on the tower: Dense_0 [70, 64] and
# Dense_1 [64, 64] have >= 4096 elements, the rest stays float.
F, HIDDEN, LIST = 70, (64, 64), 8
TOL = 1e-5


def _specs(pkg):
  return {'x': pkg.FixedLenFeature((F,), 'float32', 0.0),
          'relevance': pkg.FixedLenFeature((), 'int64', 0)}


def _variables():
  """Flax variables with non-trivial BN statistics, from a seed."""
  jmodel = jax_models.RankingModel(
      scorer=jax_models.DNNScorer(hidden_layer_dims=HIDDEN, dropout=0.0),
      transform_name='log1p')
  variables = jmodel.init(jax.random.PRNGKey(0), {},
                          {'x': jnp.zeros((2, LIST, F))},
                          jnp.ones((2, LIST), bool), training=False)
  rng = np.random.RandomState(1)
  variables = jax.tree_util.tree_map_with_path(
      lambda p, x: (rng.uniform(0.5, 2.0, np.shape(x)) if 'var' in
                    jax.tree_util.keystr(p) else
                    np.asarray(x) + 0.3 * rng.randn(*np.shape(x))
                    ).astype(np.float32),
      jax.tree.map(np.asarray, dict(variables)))
  return jmodel, variables


def _elwcs(seed, lengths):
  rng = np.random.RandomState(seed)
  return [proto.make_elwc({}, [
      {'x': (rng.randn(F) * 4).astype(np.float32),
       'relevance': [int(rng.randint(0, 5))]} for _ in range(n)])
      for n in lengths]


def _sample(pkg_parsers, records):
  parsed = pkg_parsers.parse_example_list(
      records, {}, {'x': _specs(pkg_parsers)['x']}, list_size=LIST)
  return parsed


@pytest.fixture(scope='module')
def artifacts(tmp_path_factory):
  """{quantize: (JAX predictor, port predictor, JAX path, port path)}."""
  root = tmp_path_factory.mktemp('artifacts')
  jmodel, variables = _variables()
  tmodel = scorers.RankingModel(scorers.DNNScorer(HIDDEN, in_features=F,
                                                  dropout=0.0),
                                transform_name='log1p')
  state = convert.from_flax(variables)
  records = _elwcs(0, [3, LIST, 5])
  jp = _sample(jax_parsers, records)
  tp = _sample(parsers, records)
  jbatch = JaxBatch(context={}, examples=jp.examples,
                    labels=np.zeros(jp.mask.shape, np.float32), mask=jp.mask)
  tbatch = batch_lib.batch_from_labels(np.zeros(tp.mask.shape, np.float32),
                                       examples=tp.examples)
  out = {}
  for quant in (None, 'int8'):
    jpath, tpath = str(root / f'jax_{quant}'), str(root / f'torch_{quant}')
    jax_export.export_predictor(
        jmodel, variables, {}, _specs(jax_parsers), jpath, jbatch,
        list_size_buckets=(LIST,), label_feature_name='relevance',
        quantize=quant)
    export.export_predictor(
        tmodel, state, {}, _specs(parsers), tpath, tbatch,
        list_size_buckets=(LIST,), label_feature_name='relevance',
        quantize=quant)
    out[quant] = (jax_export.load_predictor(jpath),
                  export.load_predictor(tpath, device='cpu'), jpath, tpath)
  return out


@pytest.mark.parametrize('quant', [None, 'int8'])
def test_predict_regress_score_batch_match_jax(artifacts, quant):
  want, got, jpath, tpath = artifacts[quant]
  requests = _elwcs(2, [4, 1, LIST, 6, 2])
  a, b = got.predict(requests), want.predict(requests)
  assert a.shape == b.shape == (5, LIST) and a.dtype == np.float32
  np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
  singles = [proto.make_example({'x': (np.random.RandomState(s).randn(F)
                                       * 4).astype(np.float32)})
             for s in range(4)]
  np.testing.assert_allclose(got.regress(singles), want.regress(singles),
                             atol=TOL, rtol=0)
  parsed = parsers.parse(requests, {}, {'x': _specs(parsers)['x']}, LIST)
  batch = batch_lib.batch_from_labels(
      np.where(parsed.mask, 0.0, -1.0).astype(np.float32),
      examples={**parsed.examples,
                'relevance': np.zeros(parsed.mask.shape + (1,), np.float32)})
  jbatch = JaxBatch(context={}, examples={'x': parsed.examples['x']},
                    labels=None, mask=parsed.mask)
  np.testing.assert_allclose(got.score_batch(batch), want.score_batch(jbatch),
                             atol=TOL, rtol=0)
  with open(os.path.join(jpath, 'manifest.json')) as f:
    jm = json.load(f)
  with open(os.path.join(tpath, 'manifest.json')) as f:
    tm = json.load(f)
  assert tm == jm  # every key, the spec JSON, buckets and quantize


def test_int8_values_and_scales_bit_equal_to_jax(artifacts):
  """Dense kernels per output channel, in the flax layout."""
  _, _, jpath, tpath = artifacts['int8']
  with np.load(os.path.join(jpath, 'params.npz')) as z:
    jq = {k: z[k] for k in z.files}
  with np.load(os.path.join(tpath, 'params.npz')) as z:
    tq = {k: z[k] for k in z.files}
  for i in range(len(HIDDEN)):
    for leaf in ('__q__', '__scale__'):
      want = jq[f'params|scorer|Tower_0|Dense_{i}|kernel|{leaf}']
      got = tq[f'scorer|tower|dense|{i}|weight|{leaf}']
      assert got.dtype == want.dtype
      np.testing.assert_array_equal(got.T, want)
  # The output layer [64, 1] and the vectors stay float32.
  assert tq[f'scorer|tower|dense|{len(HIDDEN)}|weight'].dtype == np.float32
  assert sum(k.endswith('__q__') for k in tq) == sum(
      k.endswith('__q__') for k in jq) == len(HIDDEN)


def test_int8_tables_per_row_bit_equal_to_jax():
  jmodel = jax_models.RankingModel(scorer=jax_models.EmbeddingDNNScorer(
      hidden_layer_dims=(16,), vocab_sizes={'tok': 1024}, embedding_dim=16,
      dropout=0.0, use_batch_norm=False))
  variables = jax.tree.map(np.asarray, dict(jmodel.init(
      jax.random.PRNGKey(2), {}, {'tok': jnp.zeros((2, 3, 4), jnp.int32)},
      jnp.ones((2, 3), bool), training=False)))
  tmodel = scorers.RankingModel(scorers.EmbeddingDNNScorer(
      (16,), {'tok': 1024}, embedding_dim=16, dropout=0.0,
      use_batch_norm=False))
  want = jax_export.quantize_variables(variables)
  got = export.quantize_variables(
      export._nest(convert.from_flax(variables)),
      transposed=[f'{n}.weight' for n, m in tmodel.named_modules()
                  if isinstance(m, torch.nn.Linear)])
  table = want['params']['scorer']['embed_tok']['embedding']
  assert table['__scale__'].shape == (1024, 1)  # per row
  mine = got['scorer']['embed_tok']['embedding']
  for leaf in ('__q__', '__scale__'):
    np.testing.assert_array_equal(mine[leaf], table[leaf])


def test_bfloat16_leaves_round_trip(tmp_path):
  tree = {'w': torch.arange(6, dtype=torch.float32).to(
      torch.bfloat16).reshape(2, 3), 'b': torch.ones(3)}
  path = str(tmp_path / 'p.npz')
  np.savez(path, **export._flatten_vars(tree))
  with np.load(path) as z:
    back = export._unflatten_vars({k: z[k] for k in z.files})
  assert back['w'].dtype == torch.bfloat16 and back['b'].dtype == torch.float32
  assert torch.equal(back['w'], tree['w'])
  # The JAX package reads the same file (ml_dtypes on its side).
  with np.load(path) as z:
    jback = jax_export._unflatten_vars({k: z[k] for k in z.files})
  np.testing.assert_array_equal(jback['w'].astype(np.float32),
                                tree['w'].float().numpy())
  # A bf16 matrix is quantized like a float32 one.
  q = export.quantize_variables({'w': torch.ones(64, 64,
                                                 dtype=torch.bfloat16)})
  assert q['w']['__q__'].dtype == np.int8


_DRIVER = """
import sys
sys.modules['ranking_tpu_torch.models'] = None   # importing it raises
import numpy as np, torch
from ranking_tpu_torch.data import tfrecord
from ranking_tpu_torch.pipeline import export
lp = export.load_predictor({path!r}, device='cpu')
records = list(tfrecord.read_records({records!r}))
singles = list(tfrecord.read_records({singles!r}))
scores = lp.predict(records)
reg = lp.regress(singles)
tree = {{'w': torch.ones(2, 2, dtype=torch.bfloat16)}}
np.savez({bf16!r}, **export._flatten_vars(tree))
with np.load({bf16!r}) as z:
  assert export._unflatten_vars(dict(z))['w'].dtype == torch.bfloat16
bad = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes', 'ranking_tpu')
    or m.startswith('ranking_tpu_torch.models')))
assert not bad, bad
np.savez({out!r}, scores=scores, reg=reg)
"""


def test_loads_without_model_code(artifacts, tmp_path):
  from ranking_tpu_torch.data import tfrecord
  _, got, _, tpath = artifacts['int8']
  records = _elwcs(3, [2, 7])
  singles = [proto.make_example({'x': np.full(F, 0.5, np.float32)})]
  paths = {k: str(tmp_path / f'{k}.tfrecord') for k in ('records', 'singles')}
  tfrecord.write_records(paths['records'], records)
  tfrecord.write_records(paths['singles'], singles)
  out = str(tmp_path / 'out.npz')
  driver = _DRIVER.format(path=tpath, out=out, bf16=str(tmp_path / 'b.npz'),
                          **paths)
  repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  proc = subprocess.run([sys.executable, '-c', driver], capture_output=True,
                        text=True, timeout=120, cwd=repo)
  assert proc.returncode == 0, proc.stderr[-3000:]
  with np.load(out) as z:
    np.testing.assert_array_equal(z['scores'], got.predict(records))
    np.testing.assert_array_equal(z['reg'], got.regress(singles))


def test_edge_contracts_and_raises_match_jax(artifacts, tmp_path):
  _, got, _, _ = artifacts[None]
  assert got.predict([]).shape == (0, LIST)
  assert got.regress([]).shape == (0,)
  assert got.buckets == [1, LIST]
  with pytest.raises(ValueError, match='largest exported bucket'):
    got.predict(_elwcs(4, [LIST + 1]))
  with pytest.raises(ValueError, match='requires an exported bucket size'):
    got.score_batch(batch_lib.batch_from_labels(
        np.zeros((1, 3), np.float32),
        examples={'x': np.zeros((1, 3, F), np.float32)}))

  tmodel = scorers.RankingModel(scorers.DNNScorer((4,), in_features=F))
  sample = batch_lib.batch_from_labels(
      np.zeros((2, 3), np.float32),
      examples={'x': np.zeros((2, 3, F), np.float32)})
  spec = {'x': parsers.FixedLenFeature((F,), 'float32', 0.0),
          'phantom': parsers.FixedLenFeature((2,), 'float32', 0.0)}
  with pytest.raises(ValueError, match='phantom'):
    export.export_predictor(tmodel, None, {}, spec, str(tmp_path / 'a'),
                            sample)
  spec = {'x': spec['x']}
  with pytest.raises(ValueError, match="quantize must be 'int8'"):
    export.export_predictor(tmodel, None, {}, spec, str(tmp_path / 'b'),
                            sample, quantize='int4')
  small = scorers.RankingModel(scorers.DNNScorer((4,), in_features=3))
  small_sample = batch_lib.batch_from_labels(
      np.zeros((2, 3), np.float32),
      examples={'x': np.zeros((2, 3, 3), np.float32)})
  small_spec = {'x': parsers.FixedLenFeature((3,), 'float32', 0.0)}
  with pytest.raises(ValueError, match='matched no variables'):
    export.export_predictor(small, None, {}, small_spec, str(tmp_path / 'c'),
                            small_sample, quantize='int8')
  for bad in ({'scorer': {'heads': [torch.zeros(2, 2)]}},
              {'scorer': (torch.zeros(2),)}):
    with pytest.raises(TypeError, match='nested dict'):
      export.export_predictor(small, bad, {}, small_spec,
                              str(tmp_path / 'd'), small_sample)
  with pytest.raises(TypeError, match='reserved separator'):
    export.export_predictor(small, {'a|b': torch.zeros(2)}, {}, small_spec,
                            str(tmp_path / 'e'), small_sample)


def test_vocab_non_utf8_tokens_round_trip():
  vocab = parsers.Vocabulary([b'plain', b'\xe9\xff\x00binary', b'caf\xc3\xa9'],
                             num_oov_buckets=2)
  spec = parsers.VarLenFeature(dtype='string', max_len=4, vocab=vocab)
  d = export.spec_to_json(spec)
  back = export.spec_from_json(json.loads(json.dumps(d)))
  assert back.vocab._map == vocab._map
  jvocab = jax_parsers.Vocabulary(
      [b'plain', b'\xe9\xff\x00binary', b'caf\xc3\xa9'], num_oov_buckets=2)
  want = jax_export.spec_to_json(jax_parsers.VarLenFeature(
      dtype='string', max_len=4, vocab=jvocab))
  assert d == want
