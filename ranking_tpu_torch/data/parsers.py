"""Serialized ranking protos -> padded numpy arrays.

The port's copy of ``ranking_tpu/data/parsers.py`` (the reference's parser
family, tensorflow_ranking/python/data.py:99-710): ExampleListWithContext,
ExampleInExample, SequenceExample and plain tf.Example, all producing the
shared batch model: context ``[B, ...]``, examples ``[B, L, ...]`` with a
fixed ``list_size`` (truncate or pad), and the sizes and mask of the lists.
Var-len token features become ``[.., T]`` int64 arrays padded with -1;
strings become int64 ids through a vocabulary or a 64-bit FNV-1a hash, on
the host, so that nothing string-typed reaches the card.

The four ``parse_*`` functions are the plain parsers, over the wire
decoder of ``data/proto.py``. ``parse`` is the entry point: it runs the
native decoder (``data/native``) wherever ``native.decode_supported``
accepts the specs, and the plain parser where it rejects them or where the
caller asks for it. It does not fall back: a native error on specs the
check accepted raises. ``parser_runs`` counts the parses of each kind.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from ranking_tpu_torch.data import proto

PADDING_LABEL = -1.0

_FNV64_OFFSET = 0xCBF29CE484222325
_FNV64_PRIME = 0x100000001B3

# Parses run through ``parse`` in this process, by parser ('native' or
# 'python'), so that a run can show which parser it went through.
parser_runs: collections.Counter = collections.Counter()


def fnv1a_64(data: bytes) -> int:
  """Stable 64-bit FNV-1a hash (string -> hash-bucket ids)."""
  h = _FNV64_OFFSET
  for b in data:
    h = ((h ^ b) * _FNV64_PRIME) & 0xFFFFFFFFFFFFFFFF
  return h


class Vocabulary:
  """String -> id lookup from a vocab file or a token list (StringLookup,
  examples/keras/antique_ragged.py:100-160). A known token maps to its
  index + ``num_oov_buckets``; an unknown one to ``fnv1a_64 %
  num_oov_buckets``."""

  def __init__(self, path_or_tokens, num_oov_buckets: int = 1):
    if isinstance(path_or_tokens, (list, tuple)):
      tokens = [t.encode() if isinstance(t, str) else t
                for t in path_or_tokens]
    else:
      with open(path_or_tokens, 'rb') as f:
        tokens = [line.rstrip(b'\r\n') for line in f if line.rstrip(b'\r\n')]
    self.num_oov_buckets = max(1, num_oov_buckets)
    self.tokens = tokens  # id order; the native table is built from it
    self._map = {t: i + self.num_oov_buckets for i, t in enumerate(tokens)}
    self.size = len(tokens) + self.num_oov_buckets

  def lookup(self, token: bytes) -> int:
    idx = self._map.get(token)
    if idx is not None:
      return idx
    return fnv1a_64(token) % self.num_oov_buckets


@dataclasses.dataclass(frozen=True)
class FixedLenFeature:
  """Dense feature with a fixed per-example shape (tf.io.FixedLenFeature)."""
  shape: Tuple[int, ...] = ()
  dtype: str = 'float32'        # 'float32' | 'int64' | 'string'
  default_value: Optional[Union[float, int, str]] = None


@dataclasses.dataclass(frozen=True)
class VarLenFeature:
  """Variable-length feature, densified to ``[.., max_len]`` with padding.

  ``max_len`` fixes the token axis (truncate or pad); None means the
  batch's longest. For the 'string' dtype, tokens become int64 ids through
  ``vocab`` (a Vocabulary) or ``hash_buckets`` (FNV-1a mod buckets).
  """
  dtype: str = 'float32'
  max_len: Optional[int] = None
  pad_value: Union[float, int] = -1
  vocab: Optional[Vocabulary] = None
  hash_buckets: Optional[int] = None


FeatureSpec = Union[FixedLenFeature, VarLenFeature]

_LIST_OF = {'float32': proto.FLOAT_LIST, 'int64': proto.INT64_LIST,
            'string': proto.BYTES_LIST}


def _np_dtype(dtype: str):
  return {'float32': np.float32, 'int64': np.int64,
          'string': np.int64}[dtype]


def _feature_values(feature: proto.Feature, dtype: str):
  if dtype not in _LIST_OF:
    raise ValueError(f'Unknown dtype {dtype!r}')
  return feature.values if feature.kind == _LIST_OF[dtype] else []


def _encode_strings(values: List[bytes], spec: VarLenFeature) -> List[int]:
  if spec.vocab is not None:
    return [spec.vocab.lookup(v) for v in values]
  if spec.hash_buckets:
    return [fnv1a_64(v) % spec.hash_buckets for v in values]
  raise ValueError('string VarLenFeature needs vocab or hash_buckets')


def _wrong_type(feature: proto.Feature, dtype: str) -> bool:
  """True when the stored Feature holds values of another list type than
  the spec asks for: a schema error, not an absent feature."""
  return feature.kind not in (None, _LIST_OF[dtype]) and len(
      feature.values) > 0


def _extract(fmap: Mapping[str, proto.Feature], name: str, spec: FeatureSpec):
  """One example's values of a feature, as a list or array."""
  present = name in fmap
  if isinstance(spec, FixedLenFeature):
    if spec.dtype == 'string':
      raise ValueError(
          f"FixedLenFeature dtype='string' is not supported ({name!r}); "
          'strings become int ids host-side — use VarLenFeature with '
          'vocab= or hash_buckets=')
    size = int(np.prod(spec.shape)) if spec.shape else 1
    vals = _feature_values(fmap[name], spec.dtype) if present else []
    if len(vals) == 0:
      if present and _wrong_type(fmap[name], spec.dtype):
        raise ValueError(
            f'Feature {name!r}: stored value type does not match spec '
            f'dtype {spec.dtype!r} (tf.io.parse_example raises here too)')
      if spec.default_value is None:
        raise ValueError(f'Missing required feature {name!r}')
      return [spec.default_value] * size
    if len(vals) != size:
      raise ValueError(
          f'Feature {name!r}: got {len(vals)} values, expected {size}')
    return vals
  vals = _feature_values(fmap[name], spec.dtype) if present else []
  if spec.dtype == 'string':
    vals = _encode_strings(vals, spec)
  return vals


def _stack_fixed(rows: List, spec: FixedLenFeature) -> np.ndarray:
  arr = np.asarray(rows, dtype=_np_dtype(spec.dtype))
  return arr.reshape((arr.shape[0],) + tuple(spec.shape))


def _stack_varlen(rows: List, spec: VarLenFeature) -> np.ndarray:
  max_len = spec.max_len
  if max_len is None:
    max_len = max((len(r) for r in rows), default=1) or 1
  out = np.full((len(rows), max_len), spec.pad_value,
                dtype=_np_dtype(spec.dtype))
  for i, r in enumerate(rows):
    n = min(len(r), max_len)
    if n:
      out[i, :n] = r[:n]
  return out


def _stack(rows: List, spec: FeatureSpec) -> np.ndarray:
  if isinstance(spec, FixedLenFeature):
    return _stack_fixed(rows, spec)
  return _stack_varlen(rows, spec)


def _pad_value_row(spec: FeatureSpec) -> List:
  """A row of padding values for one absent (padded) document."""
  if isinstance(spec, FixedLenFeature):
    size = int(np.prod(spec.shape)) if spec.shape else 1
    d = spec.default_value
    if d is None:
      d = 0.0 if spec.dtype == 'float32' else (b'' if spec.dtype == 'string'
                                               else 0)
    elif spec.dtype == 'string' and isinstance(d, str):
      d = d.encode()
    return [d] * size
  return []


@dataclasses.dataclass
class ParsedLists:
  """Parser output before batch assembly."""
  context: Dict[str, np.ndarray]   # [B, ...]
  examples: Dict[str, np.ndarray]  # [B, L, ...]
  sizes: np.ndarray                # [B] int32, real documents a list
  mask: np.ndarray                 # [B, L] bool


def _assemble(
    context_rows: Dict[str, List],
    example_rows: Dict[str, List[List]],
    sizes: List[int],
    context_spec: Mapping[str, FeatureSpec],
    example_spec: Mapping[str, FeatureSpec],
    list_size: Optional[int],
) -> ParsedLists:
  batch = len(sizes)
  target = list_size or max(sizes, default=1) or 1
  clipped = np.minimum(np.asarray(sizes, np.int32), target)
  mask = np.arange(target)[None, :] < clipped[:, None]
  context = {name: _stack(rows, context_spec[name])
             for name, rows in context_rows.items()}
  examples = {}
  for name, lists in example_rows.items():
    spec = example_spec[name]
    flat: List = []
    for row in lists:
      row = row[:target]
      flat.extend(row)
      flat.extend([_pad_value_row(spec)] * (target - len(row)))
    arr = _stack(flat, spec)
    examples[name] = arr.reshape((batch, target) + arr.shape[1:])
  return ParsedLists(context=context, examples=examples,
                     sizes=clipped, mask=mask)


def _maybe_shuffle(indices: List[int], shuffle: bool,
                   rng: Optional[np.random.RandomState]) -> List[int]:
  if shuffle:
    (rng or np.random).shuffle(indices)
  return indices


def bucket_list_size(longest: int) -> int:
  """Pads a list size up the half-step power-of-two ladder (1, 2, 3, 4, 6,
  8, 12, 16, 24, 32, ...): few distinct shapes, at most 33% padding. The
  serving path (``Predictor.predict`` with ``list_size=None``) and bucketed
  training batches share it."""
  longest = max(1, int(longest))
  pow2 = 1 << (longest - 1).bit_length()
  half_step = (pow2 // 4) * 3
  return half_step if half_step >= longest else pow2


def elwc_list_sizes(serialized: Sequence[bytes]) -> np.ndarray:
  """[B] int32 list lengths of serialized ELWC protos: a walk of the top
  level that counts the ``examples`` field (field 1), with no feature
  decoding, in C++ (``rt_elwc_sizes``). ``_elwc_list_sizes_py`` is its
  plain version."""
  from ranking_tpu_torch.data import native
  return native.elwc_sizes(serialized)


def _elwc_list_sizes_py(serialized: Sequence[bytes]) -> np.ndarray:
  """The plain version of ``elwc_list_sizes``."""
  return np.asarray(
      [sum(1 for field, wire, _, _ in proto.fields(rec)
           if field == 1 and wire == 2) for rec in serialized], np.int32)


def _parse_lists(records, context_spec, example_spec, list_size,
                 shuffle_examples, rng) -> ParsedLists:
  """(context features, documents' features) pairs -> ParsedLists."""
  ctx_rows = {n: [] for n in context_spec}
  ex_rows = {n: [] for n in example_spec}
  sizes = []
  for context, docs in records:
    for name, spec in context_spec.items():
      ctx_rows[name].append(_extract(context, name, spec))
    order = _maybe_shuffle(list(range(len(docs))), shuffle_examples, rng)
    for name, spec in example_spec.items():
      ex_rows[name].append([_extract(docs[i], name, spec) for i in order])
    sizes.append(len(docs))
  return _assemble(ctx_rows, ex_rows, sizes, context_spec, example_spec,
                   list_size)


def parse_example_list(
    serialized: Sequence[bytes],
    context_spec: Mapping[str, FeatureSpec],
    example_spec: Mapping[str, FeatureSpec],
    list_size: Optional[int] = None,
    shuffle_examples: bool = False,
    rng: Optional[np.random.RandomState] = None,
) -> ParsedLists:
  """Parses serialized ELWC protos (python/data.py:391-539)."""
  return _parse_lists((proto.decode_elwc(rec) for rec in serialized),
                      context_spec, example_spec, list_size,
                      shuffle_examples, rng)


def _decode_eie(rec) -> Tuple[Dict, List[Dict]]:
  outer = proto.decode_example(rec)

  def carried(name):
    feature = outer.get(name)
    return (feature.values if feature is not None
            and feature.kind == proto.BYTES_LIST else [])

  ctx_bytes = carried('serialized_context')
  return ((proto.decode_example(ctx_bytes[0]) if ctx_bytes else {}),
          [proto.decode_example(b) for b in carried('serialized_examples')])


def parse_example_in_example(
    serialized: Sequence[bytes],
    context_spec: Mapping[str, FeatureSpec],
    example_spec: Mapping[str, FeatureSpec],
    list_size: Optional[int] = None,
    shuffle_examples: bool = False,
    rng: Optional[np.random.RandomState] = None,
) -> ParsedLists:
  """Parses ExampleInExample records: an outer tf.Example holding
  'serialized_context' (one bytes value) and 'serialized_examples'
  (repeated bytes) (python/data.py:133-208, 211-380)."""
  return _parse_lists((_decode_eie(rec) for rec in serialized),
                      context_spec, example_spec, list_size,
                      shuffle_examples, rng)


def parse_sequence_example(
    serialized: Sequence[bytes],
    context_spec: Mapping[str, FeatureSpec],
    example_spec: Mapping[str, FeatureSpec],
    list_size: Optional[int] = None,
) -> ParsedLists:
  """Parses SequenceExample records: context Features and per-document
  FeatureLists along the frame axis (python/data.py:572-710)."""
  ctx_rows = {n: [] for n in context_spec}
  ex_rows = {n: [] for n in example_spec}
  sizes = []
  for rec in serialized:
    context, flists = proto.decode_sequence_example(rec)
    for name, spec in context_spec.items():
      ctx_rows[name].append(_extract(context, name, spec))
    n_frames = max((len(flists[n]) for n in example_spec if n in flists),
                   default=0)
    for name, spec in example_spec.items():
      frames = flists.get(name, [])
      ex_rows[name].append([
          _extract({name: frames[i]}, name, spec) if i < len(frames)
          else _pad_value_row(spec) for i in range(n_frames)])
    sizes.append(n_frames)
  return _assemble(ctx_rows, ex_rows, sizes, context_spec, example_spec,
                   list_size)


def parse_tf_example(
    serialized: Sequence[bytes],
    context_spec: Mapping[str, FeatureSpec],
    example_spec: Mapping[str, FeatureSpec],
    list_size: int = 1,
) -> ParsedLists:
  """Pointwise serving parser: each record is one document, in a list of
  ``list_size`` slots (python/data.py:1348-1395)."""
  records = []
  for rec in serialized:
    features = proto.decode_example(rec)
    records.append((features, [features]))
  return _parse_lists(records, context_spec, example_spec, list_size,
                      False, None)


PARSER_FNS = {
    'example_list_with_context': parse_example_list,
    'example_in_example': parse_example_in_example,
    'sequence_example': parse_sequence_example,
    'tf_example': parse_tf_example,
}


def parse(
    serialized: Sequence[bytes],
    context_spec: Mapping[str, FeatureSpec],
    example_spec: Mapping[str, FeatureSpec],
    list_size: int,
    data_format: str = 'example_list_with_context',
    use_native: bool = True,
) -> ParsedLists:
  """One batch of records through the native decoder where
  ``native.decode_supported`` accepts the specs (and ``use_native``), else
  through the plain parser. The entry point of every serving call and of
  the Python stream's batches. A native failure raises (a corrupt record,
  a missing required feature, a wrong value count or type), as the plain
  parser does for the same input; nothing falls back."""
  if data_format not in PARSER_FNS:
    raise ValueError(f'Unknown data_format {data_format!r}; '
                     f'one of {sorted(PARSER_FNS)}')
  from ranking_tpu_torch.data import native
  if use_native and native.decode_supported(context_spec, example_spec,
                                            data_format, list_size):
    parsed = native.decode_elwc_batch(list(serialized), list_size,
                                      context_spec,
                                      example_spec, data_format=data_format)
    parser_runs['native'] += 1
    return parsed
  parsed = PARSER_FNS[data_format](serialized, context_spec, example_spec,
                                   list_size=list_size)
  parser_runs['python'] += 1
  return parsed
