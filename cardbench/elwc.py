"""Serialized ``ExampleListWithContext`` requests, written by the benchmark.

The wire format of tensorflow_serving's ``input.proto`` and TensorFlow's
``example.proto``: an ELWC holds ``examples`` (field 1, one ``Example`` a
document) and ``context`` (field 2); an ``Example`` holds ``Features``
(field 1), a map of name to ``Feature`` entries (field 1: key 1, value 2);
a ``Feature`` of integers holds an ``Int64List`` (field 3) of packed
varints (field 1). The benchmark makes its requests' bytes itself, so that
the program under test only reads them.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np


def _varint(n: int) -> bytes:
  out = bytearray()
  while True:
    byte = n & 0x7F
    n >>= 7
    if n:
      out.append(byte | 0x80)
    else:
      out.append(byte)
      return bytes(out)


def _field(number: int, payload: bytes) -> bytes:
  """A length-delimited field."""
  return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def packed_varints(values: np.ndarray) -> bytes:
  """Non-negative integers below 2**28 as concatenated varints."""
  v = np.asarray(values, np.int64).reshape(-1)
  if v.size and (v.min() < 0 or v.max() >= 1 << 28):
    raise ValueError('packed_varints takes integers in [0, 2**28)')
  groups = np.stack([(v >> (7 * i)) & 0x7F for i in range(4)], axis=1)
  length = 1 + (v >= 1 << 7) + (v >= 1 << 14) + (v >= 1 << 21)
  more = np.arange(4)[None, :] < (length - 1)[:, None]
  data = (groups | (more << 7)).astype(np.uint8)
  keep = np.arange(4)[None, :] < length[:, None]
  return data[keep].tobytes()


def _int64_feature(values: np.ndarray) -> bytes:
  return _field(3, _field(1, packed_varints(values)))


def example(features: Mapping[str, np.ndarray]) -> bytes:
  """A serialized ``Example`` of int64 features."""
  entries = b''.join(
      _field(1, _field(1, name.encode()) + _field(2, _int64_feature(v)))
      for name, v in features.items())
  return _field(1, entries)


def elwc(documents: Sequence[Mapping[str, np.ndarray]]) -> bytes:
  """A serialized ELWC of the documents and an empty context."""
  return (b''.join(_field(1, example(doc)) for doc in documents)
          + _field(2, example({})))
