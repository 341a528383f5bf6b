"""The port's protobuf-free wire format == protobuf's, on the same bytes.

``ranking_tpu_torch.data.proto`` writes and reads Example, ELWC,
SequenceExample and ExampleInExample records by hand. Its encoder's bytes
must parse through the JAX package's protobuf messages
(``ranking_tpu.data.proto``) to what was encoded, and its decoder must
read protobuf-built bytes, and bytes that exercise each of protobuf's parse
rules, as ``ParseFromString`` does: merged message fields and concatenated
records, last-wins map keys with no stale tail, the Feature oneof, packed
and unpacked scalars, ten-byte negative int64s, float bits (-0.0, NaN
payloads), unknown fields and groups skipped, truncations raising. Values
compare exactly; floats by their bits.
"""

import struct

import numpy as np
import pytest

from ranking_tpu.data import proto as jax_proto
from ranking_tpu_torch.data import proto

v, ld = proto.varint, proto.length_delimited


def _canon_pb(features_msg):
  """{name: (kind, values)} of a protobuf Features message."""
  out = {}
  for name, feat in features_msg.feature.items():
    kind = feat.WhichOneof('kind')
    values = list(getattr(feat, kind).value) if kind else []
    if kind == 'float_list':
      values = np.asarray(values, np.float32).view(np.uint32).tolist()
    out[name] = (kind, values)
  return out


def _canon(features):
  """The same of the port decoder's {name: Feature}."""
  out = {}
  for name, feat in features.items():
    values = list(feat.values)
    if feat.kind == proto.FLOAT_LIST:
      values = np.asarray(feat.values, np.float32).view(np.uint32).tolist()
    out[name] = (feat.kind, values)
  return out


def _example_pb(data: bytes):
  return jax_proto.Example.FromString(data)


def _docs(seed, n):
  rng = np.random.RandomState(seed)
  return [{'f': [float(x) for x in rng.randn(4).astype(np.float32)],
           'rel': [int(rng.randint(0, 5))],
           'ids': [int(x) for x in rng.randint(-2**62, 2**62, size=3)],
           'tok': ['a', 'bb', b'\x00\xff'][:rng.randint(0, 4)]}
          for _ in range(n)]


CONTEXT = {'q': [3], 'qt': ['x', 'y z'], 'w': [0.5]}


def test_encoder_and_decoder_agree_with_protobuf_on_elwc():
  docs = _docs(0, 5)
  ours = proto.make_elwc(CONTEXT, docs)
  theirs = jax_proto.make_elwc(CONTEXT, docs).SerializeToString()
  for data in (ours, theirs):
    pb = jax_proto.ExampleListWithContext.FromString(data)
    context, examples = proto.decode_elwc(data)
    assert _canon(context) == _canon_pb(pb.context.features)
    assert [_canon(e) for e in examples] == [
        _canon_pb(e.features) for e in pb.examples]
  # Equal after parsing, not byte for byte (map order is not promised).
  assert jax_proto.ExampleListWithContext.FromString(ours) == (
      jax_proto.ExampleListWithContext.FromString(theirs))


def test_encoder_and_decoder_agree_with_protobuf_on_sequence_example():
  frames = {'f': [[1.5, -2.0], [0.25, 4.0], [8.0, 1.0]], 'rel': [[1], [0]],
            'tok': [['a'], ['b', 'c']]}
  data = proto.make_sequence_example({'q': [7]}, frames)
  pb = jax_proto.SequenceExample.FromString(data)
  context, flists = proto.decode_sequence_example(data)
  assert _canon(context) == _canon_pb(pb.context)
  for name, flist in pb.feature_lists.feature_list.items():
    holder = jax_proto.Features()
    got = [_canon({name: f}) for f in flists[name]]
    want = []
    for feat in flist.feature:
      holder.feature[name].CopyFrom(feat)
      want.append(_canon_pb(holder))
    assert got == want, name
  assert sorted(flists) == sorted(pb.feature_lists.feature_list)


def test_encoder_agrees_with_protobuf_on_example_in_example():
  docs = _docs(1, 3)
  data = proto.make_example_in_example(CONTEXT, docs)
  outer = _example_pb(data).features.feature
  ctx = outer['serialized_context'].bytes_list.value
  exs = outer['serialized_examples'].bytes_list.value
  assert _canon_pb(_example_pb(ctx[0]).features) == _canon(
      proto.decode_example(proto.make_example(CONTEXT)))
  assert [_canon_pb(_example_pb(e).features) for e in exs] == [
      _canon(proto.decode_example(proto.make_example(d))) for d in docs]


def _float_feature(values, packed=True):
  data = np.asarray(values, np.float32).view(np.uint32)
  if packed:
    return ld(2, ld(1, data.astype('<u4').tobytes()))
  return ld(2, b''.join(b'\x0d' + struct.pack('<I', int(x)) for x in data))


def _int_feature(values, packed=True):
  if packed:
    return ld(3, ld(1, b''.join(v(x) for x in values)))
  return ld(3, b''.join(b'\x08' + v(x) for x in values))


def _entry(name, feature: bytes):
  return ld(1, ld(1, name.encode()) + ld(2, feature))


def _example(*entries):
  return ld(1, b''.join(entries))


# Each case: a serialized Example that exercises one of protobuf's rules.
_RULES = {
    'merged_features_field': (
        _example(_entry('a', _float_feature([1.0])))
        + _example(_entry('b', _int_feature([2, 3])))),
    'concatenated_records': (
        proto.make_example({'a': [1.0, 2.0, 3.0], 'c': [9.0]})
        + proto.make_example({'a': [7.0], 'b': [5.0]})),
    'repeated_key_no_stale_tail': _example(
        _entry('tok', _int_feature([11, 12, 13, 14, 15])),
        _entry('tok', _int_feature([21, 22]))),
    'value_occurring_twice_in_an_entry': _example(ld(1, ld(1, b'a') + ld(
        2, _float_feature([1.0])) + ld(2, _float_feature([2.0, 3.0])))),
    'key_without_value': _example(
        _entry('a', _float_feature([1.0, 2.0])), ld(1, ld(1, b'a'))),
    'unpacked_floats_and_ints': _example(
        _entry('f', _float_feature([1.5, -2.5, 3.0], packed=False)),
        _entry('i', _int_feature([1, 300, 2**40], packed=False))),
    'packed_and_unpacked_merge': _example(_entry(
        'i', _int_feature([1, 2]) + _int_feature([3], packed=False))),
    'negative_int64': _example(_entry(
        'i', _int_feature([-1, -(2**63), 2**63 - 1, -300]))),
    'float_bits': _example(_entry('f', ld(2, ld(1, np.asarray(
        [0x80000000, 0x7FC01234, 0xFFC00001, 0x7F800000, 0x00000001],
        '<u4').tobytes())))),
    'oneof_last_kind_wins': _example(_entry(
        'x', _float_feature([1.0, 2.0]) + _int_feature([5])
        + _int_feature([6]))),
    'oneof_switch_back': _example(_entry(
        'x', _float_feature([1.0]) + _int_feature([5])
        + _float_feature([2.0]))),
    'unknown_fields_and_groups': (
        b'\x10\x96\x01' + b'\x19' + b'\x00' * 8 + b'\x25' + b'\x00' * 4
        + b'\x2b' + b'\x08\x01' + b'\x33\x34' + b'\x2c'
        + _example(_entry('a', _float_feature([1.0]) + b'\x20\x05')
                   + b'\x18\x07')
        + _example(b'\x0a\x00')),
    'known_field_on_another_wire_type': (
        b'\x08\x05' + _example(_entry('a', _float_feature([4.0])))),
    'bytes_values': _example(_entry('s', ld(1, ld(1, b'') + ld(1, b'\x00')
                                             + ld(1, 'é'.encode())))),
}


@pytest.mark.parametrize('case', sorted(_RULES))
def test_decoder_follows_parse_from_string(case):
  data = _RULES[case]
  assert _canon(proto.decode_example(data)) == _canon_pb(
      _example_pb(data).features)


def test_signalling_nan_bits_pass_through():
  """Protobuf's Python values widen floats to doubles, which quiets a
  signalling NaN; the port's decoders keep the bits as written."""
  bits = np.asarray([0x7F800001, 0xFF800123], '<u4')
  data = _example(_entry('f', ld(2, ld(1, bits.tobytes()))))
  got = proto.decode_example(data)['f'].values
  assert got.dtype == np.float32
  np.testing.assert_array_equal(got.view(np.uint32), bits)


def test_ten_byte_varints_are_encoded_for_negative_int64():
  assert proto.varint(-1) == b'\xff' * 9 + b'\x01'
  data = proto.make_example({'i': [-5]})
  assert _example_pb(data).features.feature['i'].int64_list.value == [-5]


def test_truncations_and_overlong_lengths_raise():
  """A record cut at each byte raises in both decoders, except where the
  cut falls between two top-level fields, which leaves a valid record that
  both read alike."""
  data = proto.make_elwc(CONTEXT, _docs(2, 2))
  raised = 0
  for cut in range(1, len(data)):
    try:
      pb = jax_proto.ExampleListWithContext.FromString(data[:cut])
    except Exception:  # protobuf's DecodeError
      with pytest.raises(ValueError):
        proto.decode_elwc(data[:cut])
      raised += 1
      continue
    context, examples = proto.decode_elwc(data[:cut])
    assert [_canon(e) for e in examples] == [
        _canon_pb(e.features) for e in pb.examples]
    assert _canon(context) == _canon_pb(pb.context.features)
  assert raised >= len(data) - 4
  for bad in (b'\x0a\x05abc',                       # length past the end
              b'\x0a\x80',                          # truncated length
              b'\x0d\x00\x00',                      # truncated fixed32
              b'\x08' + b'\xff' * 10 + b'\x01',     # varint of 11 bytes
              b'\x0c',                              # stray end-group
              _example(_entry('f', ld(2, ld(1, b'\x00' * 6))))):  # 6 bytes
    with pytest.raises(ValueError):
      proto.decode_example(bad)
    with pytest.raises(Exception):
      _example_pb(bad)
