"""The port's parsers == the JAX package's, on the same serialized records.

Each of the four formats (ELWC, ExampleInExample, SequenceExample,
tf.Example) goes through ``ranking_tpu.data.parsers.parse_*`` (protobuf's
``ParseFromString``), the port's plain parser (``data/proto.py``) and the
port's native decoder (``data/native/decoder.cc``). The arrays must be
exactly equal, dtype included (floats by their bits), and the port must
raise where the JAX parser raises. The native library builds once, into
the git-ignored ``_build/``, shared by every test process.
"""

import numpy as np
import pytest

from ranking_tpu.data import parsers as jax_parsers
from ranking_tpu.data import proto as jax_proto
from ranking_tpu_torch.data import native
from ranking_tpu_torch.data import parsers
from ranking_tpu_torch.data import proto

VOCAB = ['apple', 'banana', 'cherry', 'dates']


def _specs(pkg, vocab=None):
  """(context spec, example spec) of the mixed recipe in package ``pkg``."""
  vocab = vocab or pkg.Vocabulary(VOCAB, num_oov_buckets=3)
  context = {
      'q': pkg.FixedLenFeature((), 'int64', 0),
      'qf': pkg.FixedLenFeature((2,), 'float32', -1.0),
      'qt': pkg.VarLenFeature('string', max_len=3, hash_buckets=1000),
  }
  example = {
      'f': pkg.FixedLenFeature((3,), 'float32', 0.0),
      'rel': pkg.FixedLenFeature((), 'int64', None),
      'ids': pkg.VarLenFeature('int64', max_len=2),
      'tok': pkg.VarLenFeature('string', max_len=3, vocab=vocab),
      'h': pkg.VarLenFeature('string', max_len=2, hash_buckets=97),
  }
  return context, example


def _doc(rng):
  return {'f': [float(x) for x in rng.randn(3).astype(np.float32)],
          'rel': [int(rng.randint(0, 5))],
          'ids': [int(x) for x in rng.randint(-2**62, 2**62,
                                              size=rng.randint(0, 4))],
          'tok': [VOCAB[i] if i < 4 else f'oov{i}'
                  for i in rng.randint(0, 7, size=rng.randint(0, 5))],
          'h': [f'w{i}' for i in rng.randint(0, 50, size=rng.randint(0, 3))]}


def _lists(seed, n=6, max_docs=7):
  rng = np.random.RandomState(seed)
  out = []
  for i in range(n):
    context = {'q': [int(rng.randint(-5, 1000))],
               'qt': [f't{j}' for j in range(rng.randint(0, 5))]}
    if i % 2:
      context['qf'] = [float(x) for x in rng.randn(2).astype(np.float32)]
    out.append((context, [_doc(rng) for _ in range(rng.randint(0, max_docs))]))
  return out


def _assert_parsed_equal(got, want):
  for kind in ('context', 'examples'):
    g, w = getattr(got, kind), getattr(want, kind)
    assert sorted(g) == sorted(w), kind
    for k in w:
      assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, (
          k, g[k].dtype, w[k].dtype, g[k].shape, w[k].shape)
      if w[k].dtype == np.float32:
        np.testing.assert_array_equal(g[k].view(np.uint32),
                                      w[k].view(np.uint32), err_msg=k)
      else:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
  assert got.sizes.dtype == want.sizes.dtype
  np.testing.assert_array_equal(got.sizes, want.sizes)
  np.testing.assert_array_equal(got.mask, want.mask)


def _three_ways(fmt, records, list_size):
  """(JAX plain, port plain, port native) parses of the same records."""
  jax_fn = {'example_list_with_context': jax_parsers.parse_example_list,
            'example_in_example': jax_parsers.parse_example_in_example,
            'sequence_example': jax_parsers.parse_sequence_example,
            'tf_example': jax_parsers.parse_tf_example}[fmt]
  jctx, jex = _specs(jax_parsers)
  tctx, tex = _specs(parsers)
  want = jax_fn(records, jctx, jex, list_size=list_size)
  plain = parsers.PARSER_FNS[fmt](records, tctx, tex, list_size=list_size)
  fast = native.decode_elwc_batch(records, list_size, tctx, tex,
                                  data_format=fmt)
  return want, plain, fast


@pytest.mark.parametrize('list_size', [4, 8])
@pytest.mark.parametrize('encoder', ['port', 'protobuf'])
def test_elwc_matches_jax(encoder, list_size):
  lists = _lists(0)
  if encoder == 'port':
    records = [proto.make_elwc(c, d) for c, d in lists]
  else:
    records = [jax_proto.make_elwc(c, d).SerializeToString()
               for c, d in lists]
  want, plain, fast = _three_ways('example_list_with_context', records,
                                  list_size)
  _assert_parsed_equal(plain, want)
  _assert_parsed_equal(fast, want)
  assert want.examples['tok'].dtype == np.int64  # ids at full width
  np.testing.assert_array_equal(parsers.elwc_list_sizes(records),
                                jax_parsers._elwc_list_sizes_py(records))
  np.testing.assert_array_equal(parsers._elwc_list_sizes_py(records),
                                [len(d) for _, d in lists])


def test_bucketed_plain_parse_matches_jax():
  records = [proto.make_elwc(c, d) for c, d in _lists(1)]
  jctx, jex = _specs(jax_parsers)
  tctx, tex = _specs(parsers)
  _assert_parsed_equal(
      parsers.parse_example_list(records, tctx, tex, list_size=None),
      jax_parsers.parse_example_list(records, jctx, jex, list_size=None))


def test_example_in_example_matches_jax():
  records = [proto.make_example_in_example(c, d) for c, d in _lists(2)]
  want, plain, fast = _three_ways('example_in_example', records, 5)
  _assert_parsed_equal(plain, want)
  _assert_parsed_equal(fast, want)


def test_sequence_example_matches_jax():
  rng = np.random.RandomState(3)
  records = []
  for i in range(5):
    docs = [_doc(rng) for _ in range(rng.randint(0, 6))]
    frames = {k: [d[k] for d in docs]
              for k in ('f', 'rel', 'ids', 'tok', 'h')}
    frames = {k: [x for x in fr if len(x)] for k, fr in frames.items()}
    if i == 2:
      frames['f'] = frames['f'][:1]  # a shorter list: padded frames
    if i == 3:
      del frames['h']  # absent from every record: padding
    records.append(proto.make_sequence_example(
        {'q': [i], 'qt': ['a']}, {k: x for k, x in frames.items() if x}))
  want, plain, fast = _three_ways('sequence_example', records, 4)
  _assert_parsed_equal(plain, want)
  _assert_parsed_equal(fast, want)


def test_tf_example_matches_jax():
  rng = np.random.RandomState(4)
  records = [proto.make_example({**_doc(rng), 'q': [i], 'qt': ['z']})
             for i in range(6)]
  for list_size in (1, 3):
    want, plain, fast = _three_ways('tf_example', records, list_size)
    _assert_parsed_equal(plain, want)
    _assert_parsed_equal(fast, want)


def _ld(field, payload):
  return proto.length_delimited(field, payload)


def _entry(name, feature):
  return _ld(1, _ld(1, name.encode()) + _ld(2, feature))


def _floats(values):
  return _ld(2, _ld(1, np.asarray(values, '<u4').tobytes()))


# tf.Example records that exercise protobuf's rules on features the specs
# name: repeated keys, merges, the oneof, unpacked values, float bits.
_RULE_RECORDS = [
    _ld(1, _entry('f', _floats([1, 2, 3]))
        + _entry('rel', _ld(3, b'\x0a\x01\x02'))
        + _entry('f', _floats([0x80000000, 0x7FC01234, 0xFFC00001]))),
    proto.make_example({'f': [1.0, 2.0, 3.0], 'rel': [4], 'ids': [9, 8, 7]})
    + proto.make_example({'ids': [5], 'h': ['a']}),
    _ld(1, _entry('f', _floats([5, 6, 7])) + _entry(
        'rel', _ld(2, _ld(1, b'\x00' * 4)) + _ld(3, b'\x08\x7f'))),
    _ld(1, _entry('f', _floats([1, 1, 1])) + _entry(
        'rel', _ld(3, b'\x08' + proto.varint(-2**63)))
        + _entry('tok', _ld(1, _ld(1, b'apple') + _ld(1, b'')))),
    # One map entry whose value occurs twice: the two Features merge.
    _ld(1, _ld(1, _ld(1, b'f') + _ld(2, _floats([1])) + _ld(2, _floats(
        [2, 3]))) + _entry('rel', _ld(3, b'\x0a\x01\x05'))),
]


def test_protobuf_rules_through_every_parser():
  want, plain, fast = _three_ways('tf_example', _RULE_RECORDS, 1)
  _assert_parsed_equal(plain, want)
  _assert_parsed_equal(fast, want)


def _elwc_error_cases():
  ok = {'f': [1.0, 2.0, 3.0], 'rel': [1]}
  return {
      'missing_required': ([ok], [{'f': [1.0, 2.0, 3.0]}],
                           "Missing required feature 'rel'"),
      'wrong_count': ([ok], [{'f': [1.0, 2.0], 'rel': [0]}],
                      'got 2 values, expected 3'),
      'wrong_type': ([ok], [{'f': [1.0, 2.0, 3.0], 'rel': [0.5]}],
                     'stored value type does not match'),
      'wrong_type_with_a_default': (
          [ok], [{'f': [1, 2, 3], 'rel': [2]}],
          'stored value type does not match'),
      'missing_past_list_size': ([ok, ok, {'f': [1.0, 2.0, 3.0]}], [ok],
                                 "Missing required feature 'rel'"),
      'wrong_count_past_list_size': (
          [ok, ok, ok, {'f': [1.0], 'rel': [0]}], [ok],
          'got 1 values, expected 3'),
  }


@pytest.mark.parametrize('case', sorted(_elwc_error_cases()))
def test_errors_raise_as_in_jax(case):
  first, second, message = _elwc_error_cases()[case]
  records = [proto.make_elwc({}, first), proto.make_elwc({}, second)]

  def spec(pkg):
    return {'f': pkg.FixedLenFeature((3,), 'float32', 0.0),
            'rel': pkg.FixedLenFeature((), 'int64', None)}

  with pytest.raises(ValueError, match=message):
    jax_parsers.parse_example_list(records, {}, spec(jax_parsers),
                                   list_size=2)
  for use_native in (False, True):
    with pytest.raises(ValueError, match=message):
      parsers.parse(records, {}, spec(parsers), 2, use_native=use_native)


def test_string_fixed_len_and_corrupt_records_raise():
  record = proto.make_elwc({}, [{'s': ['a']}])
  spec = {'s': parsers.FixedLenFeature((), 'string', 'x')}
  assert not native.decode_supported({}, spec, list_size=1)
  with pytest.raises(ValueError, match="dtype='string' is not supported"):
    parsers.parse([record], {}, spec, 1)
  with pytest.raises(ValueError, match="dtype='string' is not supported"):
    jax_parsers.parse_example_list(
        [record], {}, {'s': jax_parsers.FixedLenFeature((), 'string', 'x')})
  rel = {'rel': parsers.FixedLenFeature((), 'int64', 0)}
  for bad in (b'\xff\xfe not a proto \x00\x01', record[:-3],
              b'\x0a\x05abc'):
    with pytest.raises(ValueError):
      parsers.parse([record, bad], {}, rel, 2)
    with pytest.raises(ValueError):
      parsers.parse([record, bad], {}, rel, 2, use_native=False)
    with pytest.raises(ValueError):
      native.elwc_sizes([bad])
    with pytest.raises(ValueError):
      parsers._elwc_list_sizes_py([bad])


def test_parse_records_the_parser_that_ran():
  records = [proto.make_elwc(c, d) for c, d in _lists(5, n=2)]
  ctx, ex = _specs(parsers)
  before = dict(parsers.parser_runs)
  parsers.parse(records, ctx, ex, 4)
  parsers.parse(records, ctx, ex, 4, use_native=False)
  # Specs the native decoder does not take go to the plain parser.
  unsupported = {'f': parsers.VarLenFeature('float32', max_len=3)}
  assert not native.decode_supported(ctx, unsupported, list_size=4)
  assert not native.decode_supported(ctx, ex, list_size=None)
  parsed = parsers.parse(records, ctx, unsupported, 4)
  assert parsed.examples['f'].dtype == np.float32
  assert parsers.parser_runs['native'] == before.get('native', 0) + 1
  assert parsers.parser_runs['python'] == before.get('python', 0) + 2


def test_vocabulary_and_hash_ids():
  vocab = parsers.Vocabulary(VOCAB + ['apple'], num_oov_buckets=3)
  jvocab = jax_parsers.Vocabulary(VOCAB + ['apple'], num_oov_buckets=3)
  for token in (b'apple', b'dates', b'kiwi', b'', b'\x00x'):
    assert vocab.lookup(token) == jvocab.lookup(token)
    assert parsers.fnv1a_64(token) == jax_parsers.fnv1a_64(token)
  # Duplicate tokens: the last wins, in both decoders.
  record = proto.make_elwc({}, [{'tok': ['apple', 'kiwi', 'dates']}])
  spec = {'tok': parsers.VarLenFeature('string', max_len=3, vocab=vocab)}
  want = [vocab.lookup(t) for t in (b'apple', b'kiwi', b'dates')]
  for use_native in (False, True):
    got = parsers.parse([record], {}, spec, 1, use_native=use_native)
    np.testing.assert_array_equal(got.examples['tok'][0, 0], want)
  assert want[0] == 7


def test_bucket_list_size_matches_jax():
  got = [parsers.bucket_list_size(n) for n in range(0, 5001)]
  assert got == [jax_parsers.bucket_list_size(n) for n in range(0, 5001)]
  assert got[200] == 256 and got[20] == 24 and got[1] == 1


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
  """No quiet fall back to the plain parser: without a compiler, a parse
  that the check sends to the native decoder raises."""
  record = proto.make_elwc({}, [{'rel': [1]}])
  spec = {'rel': parsers.FixedLenFeature((), 'int64', 0)}
  monkeypatch.setattr(native, '_lib', None)
  monkeypatch.setattr(native, 'library_path',
                      lambda: str(tmp_path / 'build' / 'lib.so'))
  monkeypatch.setattr(native.shutil, 'which', lambda name: None)
  with pytest.raises(native.NativeBuildError, match='no C\\+\\+ compiler'):
    parsers.parse([record], {}, spec, 1)
  parsers.parse([record], {}, spec, 1, use_native=False)  # asked for
