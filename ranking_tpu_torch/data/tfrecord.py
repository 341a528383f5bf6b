"""TFRecord container reading and writing without TensorFlow.

The port's copy of ``ranking_tpu/data/tfrecord.py``: the TFRecord wire
format (uint64 length, masked crc32c of the length, payload, masked crc32c
of the payload), written with valid checksums so that the files round-trip
through other TFRecord readers.
"""

from __future__ import annotations

import os
import struct
from typing import Iterable, Iterator, List, Optional

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


def read_records(path: str, verify: bool = False) -> Iterator[bytes]:
  """Yields the record payloads of one TFRecord file; with ``verify`` the
  checksums are checked too. A truncated record raises ``IOError``."""
  with open(path, 'rb') as f:
    while True:
      header = f.read(12)
      if not header:
        return
      if len(header) < 12:
        raise IOError(f'{path}: truncated record header')
      length, length_crc = struct.unpack('<QI', header)
      if verify and masked_crc(header[:8]) != length_crc:
        raise IOError(f'{path}: corrupted record length crc')
      payload = f.read(length)
      if len(payload) < length:
        raise IOError(f'{path}: truncated record payload')
      footer = f.read(4)
      if len(footer) < 4:
        raise IOError(f'{path}: truncated record data crc')
      (data_crc,) = struct.unpack('<I', footer)
      if verify and masked_crc(payload) != data_crc:
        raise IOError(f'{path}: corrupted record data crc')
      yield payload


def read_all_records(paths, verify: bool = False,
                     limit: Optional[int] = None) -> List[bytes]:
  """The payloads of one file or of several, in order, up to ``limit``."""
  if isinstance(paths, (str, os.PathLike)):
    paths = [paths]
  out: List[bytes] = []
  for p in paths:
    for rec in read_records(str(p), verify=verify):
      out.append(rec)
      if limit is not None and len(out) >= limit:
        return out
  return out
