"""The ranking data formats' protobuf messages, on the wire, without protobuf.

The port's counterpart of ``ranking_tpu/data/proto.py``, which builds the
messages with ``google.protobuf`` at run time. The port imports no
protobuf: it writes and reads the wire format by hand, as
``utils/tensorboard.py`` does for event files. This module is the encoder
(``make_example``, ``make_elwc``, ``make_sequence_example``,
``make_example_in_example``) and the plain decoder that the native one
(``data/native/decoder.cc``) is held against.

Wire contract (field numbers are the contract):
  Example.features = 1;  Features.feature = map<string, Feature> 1
  (a map entry is a message with key = 1 and value = 2);
  Feature: bytes_list = 1 / float_list = 2 / int64_list = 3, a oneof;
  {Bytes,Float,Int64}List.value = 1;
  SequenceExample.context = 1, .feature_lists = 2;
  FeatureLists.feature_list = map<string, FeatureList> 1;
  FeatureList.feature = repeated Feature 1;
  ExampleListWithContext.examples = repeated 1, .context = 2
  (tensorflow_ranking/python/data.py:66-77).

The decoder follows protobuf's parse semantics, which the JAX package gets
from ``ParseFromString``: a singular message field that occurs more than
once merges, as the concatenation of its occurrences would parse (so a
record made of two concatenated records merges too); a map key that
occurs again replaces the earlier value whole; the Feature oneof keeps the
kind that came last; packed and unpacked repeated scalars are both read;
an int64 is the low 64 bits of its varint, two's complement; float bits
pass through unchanged; a field of unknown number, or of a known number on
another wire type, is skipped by its wire type (groups included); a
truncated field or a length past its message's end raises ``ValueError``.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np

BYTES_LIST, FLOAT_LIST, INT64_LIST = 'bytes_list', 'float_list', 'int64_list'
_KIND_OF_FIELD = {1: BYTES_LIST, 2: FLOAT_LIST, 3: INT64_LIST}
_FIELD_OF_KIND = {v: k for k, v in _KIND_OF_FIELD.items()}

# --- encoding ---------------------------------------------------------------


def varint(value: int) -> bytes:
  """A base-128 varint; a negative int64 takes ten bytes."""
  value &= (1 << 64) - 1
  out = bytearray()
  while True:
    byte = value & 0x7F
    value >>= 7
    if value:
      out.append(byte | 0x80)
    else:
      out.append(byte)
      return bytes(out)


def length_delimited(field: int, payload: bytes) -> bytes:
  return varint(field << 3 | 2) + varint(len(payload)) + payload


def _kind(name: str, values) -> str:
  if isinstance(values, np.ndarray):
    if values.dtype.kind == 'f':
      return FLOAT_LIST
    if values.dtype.kind in 'iub':
      return INT64_LIST
    if values.dtype.kind in 'SU':
      return BYTES_LIST
  else:
    v0 = values[0]
    if isinstance(v0, (bytes, str)):
      return BYTES_LIST
    if isinstance(v0, (float, np.floating)):
      return FLOAT_LIST
    if isinstance(v0, (bool, int, np.integer)):
      return INT64_LIST
  raise TypeError(f'Unsupported value type for {name!r}: '
                  f'{type(values[0]) if len(values) else values.dtype}')


def encode_feature(name: str, values) -> bytes:
  """One ``Feature`` from a non-empty list or array of values: bytes or
  str -> bytes_list, floats -> float_list (packed), ints and bools ->
  int64_list (packed)."""
  kind = _kind(name, values)
  if kind == FLOAT_LIST:
    payload = length_delimited(1, np.asarray(values, '<f4').tobytes())
  elif kind == INT64_LIST:
    payload = length_delimited(
        1, b''.join(varint(int(v)) for v in np.asarray(values).reshape(-1)))
  else:
    payload = b''.join(length_delimited(1, v.encode() if isinstance(v, str)
                                        else bytes(v)) for v in values)
  return length_delimited(_FIELD_OF_KIND[kind], payload)


def _features(features: Mapping[str, object]) -> bytes:
  entries = []
  for name, values in features.items():
    if not isinstance(values, (list, tuple, np.ndarray)):
      values = [values]
    if len(values) == 0:
      continue  # an absent key, not a present and kindless Feature
    entry = (length_delimited(1, name.encode())
             + length_delimited(2, encode_feature(name, values)))
    entries.append(length_delimited(1, entry))
  return b''.join(entries)


def make_example(features: Mapping[str, object]) -> bytes:
  """A serialized ``tensorflow.Example`` from {name: values}; the value
  type is inferred as in ``encode_feature``, empty lists are left out."""
  return length_delimited(1, _features(features))


def make_elwc(context: Mapping[str, object],
              examples: Sequence[Mapping[str, object]]) -> bytes:
  """A serialized ``ExampleListWithContext``: the documents, then the
  context Example."""
  return (b''.join(length_delimited(1, make_example(ex)) for ex in examples)
          + length_delimited(2, make_example(context)))


def make_sequence_example(
    context: Mapping[str, object],
    feature_lists: Mapping[str, Sequence[object]]) -> bytes:
  """A serialized ``SequenceExample``: context features, and per name a
  FeatureList of one Feature a document (frame)."""
  entries = []
  for name, frames in feature_lists.items():
    flist = b''.join(
        length_delimited(1, encode_feature(name, v if isinstance(
            v, (list, tuple, np.ndarray)) else [v])) for v in frames)
    entries.append(length_delimited(
        1, length_delimited(1, name.encode()) + length_delimited(2, flist)))
  return (length_delimited(1, _features(context))
          + length_delimited(2, b''.join(entries)))


def make_example_in_example(
    context: Mapping[str, object],
    examples: Sequence[Mapping[str, object]]) -> bytes:
  """A serialized ExampleInExample record: an outer Example holding
  'serialized_context' (one serialized Example) and 'serialized_examples'
  (one serialized Example a document) (python/data.py:133-208)."""
  return make_example({
      'serialized_context': [make_example(context)],
      'serialized_examples': [make_example(ex) for ex in examples]})


# --- decoding ---------------------------------------------------------------


class Feature:
  """A decoded ``Feature``: the oneof's ``kind`` (None when no list is set)
  and its ``values``: a float32 array, a list of ints, or a list of
  bytes."""

  __slots__ = ('kind', 'values')

  def __init__(self, kind: Optional[str] = None, values=()):
    self.kind = kind
    self.values = values


def read_varint(buf, pos: int, end: int) -> Tuple[int, int]:
  """(value, next position); the value keeps its low 64 bits."""
  result = shift = 0
  while True:
    if pos >= end:
      raise ValueError('truncated varint')
    b = buf[pos]
    pos += 1
    result |= (b & 0x7F) << shift
    if not b & 0x80:
      return result & 0xFFFFFFFFFFFFFFFF, pos
    shift += 7
    if shift >= 70:
      raise ValueError('varint longer than 10 bytes')


def _skip_group(buf, pos: int, end: int, field: int) -> int:
  while True:
    tag, pos = read_varint(buf, pos, end)
    if tag >> 3 == 0:
      raise ValueError('field number 0')
    if tag & 7 == 4:
      if tag >> 3 != field:
        raise ValueError('mismatched end-group tag')
      return pos
    pos = _skip(buf, pos, end, tag)


def _skip(buf, pos: int, end: int, tag: int) -> int:
  wire = tag & 7
  if wire == 0:
    return read_varint(buf, pos, end)[1]
  if wire == 1:
    pos += 8
  elif wire == 5:
    pos += 4
  elif wire == 2:
    length, pos = read_varint(buf, pos, end)
    pos += length
  elif wire == 3:
    return _skip_group(buf, pos, end, tag >> 3)
  else:
    raise ValueError(f'unsupported wire type {wire}')
  if pos > end:
    raise ValueError('field runs past the end of its message')
  return pos


def fields(buf, pos: int = 0, end: Optional[int] = None
           ) -> Iterator[Tuple[int, int, int, int]]:
  """(field number, wire type, start, end) of each field of the message in
  ``buf[pos:end]``; for wire type 2 start and end bound the payload, for
  the others the field's encoded value."""
  end = len(buf) if end is None else end
  while pos < end:
    tag, pos = read_varint(buf, pos, end)
    if tag >> 3 == 0:
      raise ValueError('field number 0')
    if tag & 7 == 2:
      length, start = read_varint(buf, pos, end)
      pos = start + length
      if pos > end:
        raise ValueError('length past the end of its message')
      yield tag >> 3, 2, start, pos
    else:
      start = pos
      pos = _skip(buf, pos, end, tag)
      yield tag >> 3, tag & 7, start, pos


def _payload(buf, parts: List[Tuple[int, int]]):
  """A singular message field's occurrences as one buffer: parsing their
  concatenation is protobuf's merge of them."""
  if len(parts) == 1:
    s, e = parts[0]
    return memoryview(buf)[s:e]
  return b''.join(bytes(memoryview(buf)[s:e]) for s, e in parts)


def decode_feature(buf) -> Feature:
  """A ``Feature``: the list of the kind that came last, its occurrences
  merged."""
  kind, lists = None, []
  for field, wire, s, e in fields(buf):
    if wire == 2 and field in _KIND_OF_FIELD:
      if _KIND_OF_FIELD[field] != kind:
        kind, lists = _KIND_OF_FIELD[field], []
      lists.append((s, e))
  if kind is None:
    return Feature()
  if kind == FLOAT_LIST:
    chunks = []
    for s, e in lists:
      for field, wire, vs, ve in fields(buf, s, e):
        if field == 1 and wire in (2, 5):
          if (ve - vs) % 4:
            raise ValueError('packed floats of a length not a multiple of 4')
          chunks.append(np.frombuffer(buf, '<f4', (ve - vs) // 4, vs))
    values = (np.concatenate(chunks) if chunks
              else np.zeros(0, np.float32)).astype(np.float32)
  elif kind == INT64_LIST:
    values = []
    for s, e in lists:
      for field, wire, vs, ve in fields(buf, s, e):
        if field != 1 or wire not in (0, 2):
          continue
        pos = vs
        while pos < ve:
          v, pos = read_varint(buf, pos, ve)
          values.append(v - (1 << 64) if v >> 63 else v)
  else:
    values = [bytes(memoryview(buf)[vs:ve]) for s, e in lists
              for field, wire, vs, ve in fields(buf, s, e)
              if field == 1 and wire == 2]
  return Feature(kind, values)


def _map(buf, parts: List[Tuple[int, int]], decode_value) -> Dict:
  """A map<string, V> field's entries (key = 1, value = 2); a key that
  occurs again replaces its earlier value."""
  out = {}
  for s, e in parts:
    key, value_parts = b'', []
    for field, wire, fs, fe in fields(buf, s, e):
      if wire == 2 and field == 1:
        key = bytes(memoryview(buf)[fs:fe])
      elif wire == 2 and field == 2:
        value_parts.append((fs, fe))
    out[key.decode()] = decode_value(
        _payload(buf, value_parts) if value_parts else b'')
  return out


def decode_features(buf) -> Dict[str, Feature]:
  """A ``Features`` message: {name: Feature}."""
  return _map(buf, [(s, e) for field, wire, s, e in fields(buf)
                    if field == 1 and wire == 2], decode_feature)


def _message_parts(buf, number: int) -> List[Tuple[int, int]]:
  return [(s, e) for field, wire, s, e in fields(buf)
          if field == number and wire == 2]


def decode_example(buf) -> Dict[str, Feature]:
  """An ``Example``: its features, {name: Feature}."""
  parts = _message_parts(buf, 1)
  return decode_features(_payload(buf, parts)) if parts else {}


def decode_elwc(buf) -> Tuple[Dict[str, Feature], List[Dict[str, Feature]]]:
  """An ``ExampleListWithContext``: (context features, each document's
  features)."""
  examples, context = [], []
  for field, wire, s, e in fields(buf):
    if wire != 2:
      continue
    if field == 1:
      examples.append(decode_example(memoryview(buf)[s:e]))
    elif field == 2:
      context.append((s, e))
  return (decode_example(_payload(buf, context)) if context else {},
          examples)


def decode_sequence_example(
    buf) -> Tuple[Dict[str, Feature], Dict[str, List[Feature]]]:
  """A ``SequenceExample``: (context features, {name: one Feature a
  frame})."""
  context, lists = _message_parts(buf, 1), _message_parts(buf, 2)
  flists = {}
  if lists:
    merged = _payload(buf, lists)
    flists = _map(merged, _message_parts(merged, 1), lambda value: [
        decode_feature(memoryview(value)[s:e])
        for field, wire, s, e in fields(value) if field == 1 and wire == 2])
  return (decode_features(_payload(buf, context)) if context else {},
          flists)


# --- random corpora ---------------------------------------------------------

# Label thresholds over each list's noisy score quantiles, MSLR's skew
# (about 50/30/12/5/3% for labels 0..4), as data/libsvm.py draws them.
_LABEL_QUANTILES = (0.50, 0.80, 0.92, 0.97)


def random_lists(num_lists: int, num_features: int, min_docs: int,
                 max_docs: int, seed: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
  """(features [docs, num_features] float32, labels [docs] int64, counts
  [num_lists]) of random lists in MSLR-WEB30K's shape: a list has a length
  uniform in ``[min_docs, max_docs]``, a document normal features and a
  graded label 0..4 from its list's quantiles of a noisy linear score of
  them, so that a model can learn from them. A function of the arguments
  only."""
  rng = np.random.RandomState(seed)
  w = rng.randn(num_features) / np.sqrt(num_features)
  counts = rng.randint(min_docs, max_docs + 1, size=num_lists)
  x = rng.randn(int(counts.sum()), num_features).astype(np.float32)
  score = x @ w + rng.randn(len(x))
  labels = np.zeros(len(x), np.int64)
  start = 0
  for n in counts:
    s = score[start:start + n]
    labels[start:start + n] = np.searchsorted(
        np.quantile(s, _LABEL_QUANTILES), s, side='right')
    start += n
  return x, labels, counts


def write_random_elwc(path: str, num_lists: int, num_features: int,
                      min_docs: int, max_docs: int, seed: int = 0
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
  """Writes ``random_lists`` as a TFRecord file of ELWC records (documents
  with ``float_features`` [num_features] float32 and ``relevance`` int64,
  no context), the shape of the repo's ELWC corpora
  (benchmarks/e2e_common.py); returns what it drew."""
  from ranking_tpu_torch.data import tfrecord
  x, labels, counts = random_lists(num_lists, num_features, min_docs,
                                   max_docs, seed)
  starts = np.concatenate([[0], np.cumsum(counts)])
  tfrecord.write_records(path, (
      make_elwc({}, [{'float_features': x[d], 'relevance': labels[d:d + 1]}
                     for d in range(starts[i], starts[i + 1])])
      for i in range(num_lists)))
  return x, labels, counts
