"""TensorBoard event-file writer without TensorFlow or protobuf.

The port's copy of ``ranking_tpu/utils/tensorboard.py``. It writes the same
artifact, ``events.out.tfevents.*`` files of scalar summaries in TFRecord
framing (``data/tfrecord.py``), but encodes the few protobuf fields by hand,
so that it needs no ``google.protobuf``. The bytes equal what the JAX
package's writer serializes through protobuf: fields in number order, a
proto3 scalar left out where it holds its default, and ``simple_value``
always written (it has explicit presence in summary.proto, and TensorBoard
drops a point whose value is absent, so a scalar of exactly 0.0 must
survive).

Wire contract (tensorflow/core/util/event.proto +
tensorflow/core/framework/summary.proto field numbers):
  Event: wall_time double = 1, step int64 = 2, file_version string = 3,
         summary Summary = 5
  Summary.value repeated Value = 1; Value: tag string = 1,
         simple_value float = 2
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Mapping, Optional

import numpy as np

from ranking_tpu_torch.data.tfrecord import frame


def _varint(value: int) -> bytes:
  value &= (1 << 64) - 1  # negative int64s take ten bytes
  out = bytearray()
  while True:
    byte = value & 0x7F
    value >>= 7
    if value:
      out.append(byte | 0x80)
    else:
      out.append(byte)
      return bytes(out)


def _length_delimited(field: int, payload: bytes) -> bytes:
  return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def encode_event(wall_time: float, step: int = 0, file_version: str = '',
                 values: Optional[Mapping[str, float]] = None) -> bytes:
  """One serialized ``Event``; ``values`` (tag -> scalar) become its
  ``Summary``, which is left out when there are none."""
  out = b''
  if wall_time:
    out += b'\x09' + struct.pack('<d', wall_time)
  if step:
    out += b'\x10' + _varint(int(step))
  if file_version:
    out += _length_delimited(3, file_version.encode())
  if values:
    summary = b''
    for tag, value in values.items():
      item = _length_delimited(1, tag.encode()) if tag else b''
      with np.errstate(over='ignore'):  # protobuf stores an overflow as inf
        item += b'\x15' + np.asarray(value, '<f4').tobytes()
      summary += _length_delimited(1, item)
    out += _length_delimited(5, summary)
  return out


class SummaryWriter:
  """Append-only scalar summary writer (``tf.summary.create_file_writer``
  for scalars)."""

  def __init__(self, log_dir: str):
    os.makedirs(log_dir, exist_ok=True)
    # The pid suffix (as TF's writer uses) keeps two writers created in
    # the same second on one host from interleaving one event file.
    fname = (f'events.out.tfevents.{int(time.time())}.'
             f'{socket.gethostname()}.{os.getpid()}')
    self.path = os.path.join(log_dir, fname)
    self._file = open(self.path, 'ab')
    self._file.write(frame(encode_event(time.time(),
                                        file_version='brain.Event:2')))

  def scalars(self, step: int, values: Mapping[str, float],
              wall_time: Optional[float] = None) -> None:
    self._file.write(frame(encode_event(
        wall_time if wall_time is not None else time.time(), step=step,
        values={tag: float(v) for tag, v in values.items()})))

  def flush(self) -> None:
    self._file.flush()

  def close(self) -> None:
    self._file.close()
