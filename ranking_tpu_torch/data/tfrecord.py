"""TFRecord container writing without TensorFlow.

The port's copy of the writer half of ``ranking_tpu/data/tfrecord.py``: the
TFRecord wire format (uint64 length, masked crc32c of the length, payload,
masked crc32c of the payload), with valid checksums so that the files
round-trip through other TFRecord readers.
"""

from __future__ import annotations

import os
import struct
from typing import Iterable, List

# --- crc32c (Castagnoli), table-driven ------------------------------------

_CRC_TABLE: List[int] = []


def _make_table() -> List[int]:
  poly = 0x82F63B78
  table = []
  for n in range(256):
    c = n
    for _ in range(8):
      c = (c >> 1) ^ poly if c & 1 else c >> 1
    table.append(c)
  return table


def crc32c(data: bytes, crc: int = 0) -> int:
  global _CRC_TABLE
  if not _CRC_TABLE:
    _CRC_TABLE = _make_table()
  table = _CRC_TABLE
  crc ^= 0xFFFFFFFF
  for b in data:
    crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
  return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
  crc = crc32c(data)
  return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def frame(payload: bytes) -> bytes:
  """One record as it lies in the file."""
  header = struct.pack('<Q', len(payload))
  return (header + struct.pack('<I', masked_crc(header)) + payload
          + struct.pack('<I', masked_crc(payload)))


def write_records(path: str, records: Iterable[bytes]) -> int:
  """Writes payloads as a TFRecord file (a temp file, then an atomic
  rename); returns the record count."""
  n = 0
  tmp = path + '.tmp'
  with open(tmp, 'wb') as f:
    for rec in records:
      f.write(frame(rec))
      n += 1
  os.replace(tmp, path)
  return n
