"""Pretrained TF2 BERT checkpoint ingestion for ``EncoderScorer``.

The port's copy of ``ranking_tpu/models/bert_ckpt.py``: the reference
warm-starts its ranking model from a TF2 object-based BERT checkpoint
(tensorflow_ranking/extension/premade/tfrbert_task.py:346-361). This module
reads the checkpoint without TensorFlow (``read_tf_checkpoint``, the TF2
tensor-bundle format in numpy), maps every variable name onto the encoder's
parameter names, and returns a ready ``(encoder, parameters)`` pair.

The bundle is ``<prefix>.index``, a LevelDB-style table (blocks of
prefix-compressed keys with restart arrays, each block followed by a
compression byte and a masked CRC-32C; an index block of data-block
handles; a 48-byte footer with the metaindex and index handles and the
table's magic number), whose key ``""`` holds a ``BundleHeaderProto`` and
every other key, a tensor's name, a ``BundleEntryProto`` (dtype, shape,
shard, offset, size, masked CRC-32C of the bytes); and the tensors' raw
little-endian bytes in ``<prefix>.data-<shard>-of-<shards>``. Every tensor
read is checked against its CRC-32C (``data.native.crc32c``).

Checkpoint layout (official.nlp BertEncoder saved as
``tf.train.Checkpoint(model=encoder)``):

  layer_with_weights-0  word embeddings        -> token_embed
  layer_with_weights-1  position embeddings    -> pos_embed
  layer_with_weights-2  type embeddings        -> type_embed
  layer_with_weights-3  embedding layer norm   -> LayerNorm_0
  layer_with_weights-(4+i)  transformer layer i -> block_i
      _attention_layer/_{query,key,value}_dense  [H, A, D] kernels (the
      encoder's attention keeps the same DenseGeneral layout)
      _attention_output_dense  [A, D, H]
      _attention_layer_norm / _output_layer_norm
      _intermediate_dense [H, I] / _output_dense [I, H]
  layer_with_weights-(4+N)  pooler dense        -> pooler
"""

from __future__ import annotations

import collections
import json
import math
import os
import re
import struct
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ranking_tpu_torch.data import native
from ranking_tpu_torch.data import proto
from ranking_tpu_torch.models.encoder import TransformerEncoder

_SUFFIX = '/.ATTRIBUTES/VARIABLE_VALUE'
_TABLE_MAGIC = 0xdb4775248b80fb57
_FOOTER = 48
# tensorflow/core/framework/types.proto: DataType -> numpy dtype.
_DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8,
           5: np.int16, 6: np.int8, 9: np.int64, 10: np.bool_,
           17: np.uint16, 19: np.float16, 22: np.uint32, 23: np.uint64}
_DT_STRING = 7
_DT_BFLOAT16 = 14


def _masked(crc: int) -> int:
  return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _handle(buf, pos: int, end: int) -> Tuple[int, int, int]:
  """A BlockHandle (offset, size) and the position after it."""
  offset, pos = proto.read_varint(buf, pos, end)
  size, pos = proto.read_varint(buf, pos, end)
  return offset, size, pos


def _block(buf, offset: int, size: int, path: str
           ) -> Iterator[Tuple[bytes, memoryview]]:
  """The (key, value) entries of the table block at ``offset``, after its
  trailer's checks."""
  if offset + size + 5 > len(buf):
    raise ValueError(f'{path}: block past the end of the file')
  contents = buf[offset:offset + size]
  kind = buf[offset + size]
  stored, = struct.unpack_from('<I', buf, offset + size + 1)
  if _masked(native.crc32c(buf[offset:offset + size + 1])) != stored:
    raise ValueError(f'{path}: block at {offset} fails its CRC-32C')
  if kind != 0:
    raise ValueError(f'{path}: block at {offset} is compressed (type '
                     f'{kind}); only uncompressed tables are read')
  restarts, = struct.unpack_from('<I', contents, size - 4)
  end = size - 4 - 4 * restarts
  pos, key = 0, b''
  while pos < end:
    shared, pos = proto.read_varint(contents, pos, end)
    unshared, pos = proto.read_varint(contents, pos, end)
    length, pos = proto.read_varint(contents, pos, end)
    key = key[:shared] + bytes(contents[pos:pos + unshared])
    pos += unshared
    yield key, contents[pos:pos + length]
    pos += length


def _table(path: str) -> Iterator[Tuple[bytes, memoryview]]:
  """Every (key, value) of the table file at ``path``, in key order."""
  with open(path, 'rb') as f:
    buf = memoryview(f.read())
  if len(buf) < _FOOTER:
    raise ValueError(f'{path}: too short for a table footer')
  footer = len(buf) - _FOOTER
  magic, = struct.unpack_from('<Q', buf, footer + 40)
  if magic != _TABLE_MAGIC:
    raise ValueError(f'{path}: not a table file (bad magic number)')
  _, _, pos = _handle(buf, footer, footer + 40)          # metaindex
  index_offset, index_size, _ = _handle(buf, pos, footer + 40)
  for _, handle in _block(buf, index_offset, index_size, path):
    offset, size, _ = _handle(handle, 0, len(handle))
    yield from _block(buf, offset, size, path)


def _entry(value) -> dict:
  """A BundleEntryProto's fields."""
  out = {'dtype': 0, 'shape': [], 'shard_id': 0, 'offset': 0, 'size': 0,
         'crc32c': None, 'slices': False}
  for field, wire, s, e in proto.fields(value):
    if field == 1:
      out['dtype'] = proto.read_varint(value, s, e)[0]
    elif field == 2:
      for f2, _, s2, e2 in proto.fields(value, s, e):
        if f2 == 2:   # TensorShapeProto.dim
          size = 0
          for f3, _, s3, e3 in proto.fields(value, s2, e2):
            if f3 == 1:
              size = proto.read_varint(value, s3, e3)[0]
          out['shape'].append(size)
        elif f2 == 3 and proto.read_varint(value, s2, e2)[0]:
          raise ValueError('a checkpoint tensor of unknown rank')
    elif field in (3, 4, 5):
      out[{3: 'shard_id', 4: 'offset', 5: 'size'}[field]] = \
          proto.read_varint(value, s, e)[0]
    elif field == 6 and wire == 5:
      out['crc32c'], = struct.unpack_from('<I', value, s)
    elif field == 7:
      out['slices'] = True
  return out


def _prefix(path: str) -> str:
  """The bundle prefix of a checkpoint path: the path itself, or for a
  directory the one its ``checkpoint`` file names (as
  ``tf.train.load_checkpoint``)."""
  if not os.path.isdir(path):
    return path
  state = os.path.join(path, 'checkpoint')
  if not os.path.exists(state):
    raise ValueError(f'{path} is a directory without a checkpoint file')
  with open(state) as f:
    m = re.search(r'^model_checkpoint_path:\s*"((?:[^"\\]|\\.)*)"', f.read(),
                  re.M)
  if m is None:
    raise ValueError(f'{state} names no model_checkpoint_path')
  name = m.group(1)
  return name if os.path.isabs(name) else os.path.join(path, name)


def read_tf_checkpoint(path: str,
                       select=lambda name: True) -> Dict[str, np.ndarray]:
  """``{name: array}`` of a TF2 checkpoint's numeric tensors whose name
  ``select`` accepts (string tensors, the object graph among them, are
  skipped), each checked against its masked CRC-32C. bfloat16 tensors come
  back as float32."""
  prefix = _prefix(path)
  entries = dict(_table(prefix + '.index'))
  header = entries.pop(b'', None)
  if header is None:
    raise ValueError(f'{prefix}.index has no bundle header')
  num_shards, endianness = 1, 0
  for field, _, s, e in proto.fields(header):
    if field == 1:
      num_shards = proto.read_varint(header, s, e)[0]
    elif field == 2:
      endianness = proto.read_varint(header, s, e)[0]
  if endianness != 0:
    raise ValueError(f'{prefix}: a big-endian bundle')
  out: Dict[str, np.ndarray] = {}
  files = {}
  try:
    for key, value in entries.items():
      name = key.decode('utf-8')
      entry = _entry(value)
      if entry['dtype'] == _DT_STRING or not select(name):
        continue
      if entry['slices']:
        raise ValueError(f'{name}: a partitioned variable (tensor slices)')
      bfloat16 = entry['dtype'] == _DT_BFLOAT16
      dtype = np.dtype(np.uint16 if bfloat16 else
                       _DTYPES.get(entry['dtype'], np.void))
      if dtype == np.void:
        raise ValueError(f'{name}: unsupported dtype {entry["dtype"]}')
      if entry['size'] != math.prod(entry['shape']) * dtype.itemsize:
        raise ValueError(f'{name}: {entry["size"]} bytes for shape '
                         f'{entry["shape"]} of {dtype}')
      shard = entry['shard_id']
      if shard not in files:
        files[shard] = open(
            f'{prefix}.data-{shard:05d}-of-{num_shards:05d}', 'rb')
      f = files[shard]
      f.seek(entry['offset'])
      data = bytearray(entry['size'])
      if f.readinto(data) != entry['size']:
        raise ValueError(f'{name}: the data file ends inside the tensor')
      if (entry['crc32c'] is not None
          and _masked(native.crc32c(data)) != entry['crc32c']):
        raise ValueError(f'{name}: the tensor fails its CRC-32C')
      array = np.frombuffer(data, dtype).reshape(entry['shape'])
      if bfloat16:
        array = (array.astype(np.uint32) << 16).view(np.float32)
      out[name] = array
  finally:
    for f in files.values():
      f.close()
  return out


def _read_checkpoint(path: str) -> Dict[str, np.ndarray]:
  """The ``model/...`` variables, by their names under ``model/``."""
  raw = read_tf_checkpoint(path, lambda name: name.endswith(_SUFFIX)
                           and name.startswith('model/'))
  return {name[len('model/'):-len(_SUFFIX)]: value
          for name, value in raw.items()}


def load_tf2_bert_checkpoint(
    ckpt_path: str,
    config_path: str,
    dropout: Optional[float] = None,
) -> Tuple[TransformerEncoder, Dict[str, torch.Tensor]]:
  """Builds a ``TransformerEncoder`` from a BERT config + TF2 checkpoint.

  Returns ``(encoder, parameters)``: the encoder with the checkpoint's
  values loaded, and those values as its ``state_dict`` (float32). Raises
  KeyError if a variable the config needs is missing, ValueError if a shape
  disagrees or a checkpoint variable goes unused (the
  ``assert_existing_objects_matched`` analog of tfrbert_task.py:359).
  """
  with open(config_path) as f:
    cfg = json.load(f)
  if dropout is None:
    # The BERT config's own dropout; an explicit one overrides it.
    dropout = cfg.get('hidden_dropout_prob', 0.1)
  raw = _read_checkpoint(ckpt_path)
  num_layers = cfg['num_hidden_layers']
  params: Dict[str, torch.Tensor] = collections.OrderedDict()
  used = set()

  def take(name: str, key: str, expect_shape) -> None:
    if key not in raw:
      raise KeyError(f'checkpoint variable missing: {key}')
    value = raw[key]
    if tuple(value.shape) != tuple(expect_shape):
      raise ValueError(f'{key}: shape {value.shape} != {expect_shape}')
    used.add(key)
    params[name] = torch.from_numpy(np.array(value, np.float32))

  h = cfg['hidden_size']
  a = cfg['num_attention_heads']
  d = h // a
  i_dim = cfg['intermediate_size']
  take('token_embed.embedding', 'layer_with_weights-0/embeddings',
       (cfg['vocab_size'], h))
  take('pos_embed.embedding', 'layer_with_weights-1/embeddings',
       (cfg['max_position_embeddings'], h))
  take('type_embed.embedding', 'layer_with_weights-2/embeddings',
       (cfg.get('type_vocab_size', 2), h))
  take('LayerNorm_0.scale', 'layer_with_weights-3/gamma', (h,))
  take('LayerNorm_0.bias', 'layer_with_weights-3/beta', (h,))
  for layer in range(num_layers):
    base = f'layer_with_weights-{4 + layer}'
    block = f'block_{layer}.'
    attn = block + 'MultiHeadDotProductAttention_0.'
    for proj in ('query', 'key', 'value'):
      take(f'{attn}{proj}.kernel',
           f'{base}/_attention_layer/_{proj}_dense/kernel', (h, a, d))
      take(f'{attn}{proj}.bias',
           f'{base}/_attention_layer/_{proj}_dense/bias', (a, d))
    take(f'{attn}out.kernel', f'{base}/_attention_output_dense/kernel',
         (a, d, h))
    take(f'{attn}out.bias', f'{base}/_attention_output_dense/bias', (h,))
    take(f'{block}LayerNorm_0.scale', f'{base}/_attention_layer_norm/gamma',
         (h,))
    take(f'{block}LayerNorm_0.bias', f'{base}/_attention_layer_norm/beta',
         (h,))
    take(f'{block}Dense_0.kernel', f'{base}/_intermediate_dense/kernel',
         (h, i_dim))
    take(f'{block}Dense_0.bias', f'{base}/_intermediate_dense/bias',
         (i_dim,))
    take(f'{block}Dense_1.kernel', f'{base}/_output_dense/kernel',
         (i_dim, h))
    take(f'{block}Dense_1.bias', f'{base}/_output_dense/bias', (h,))
    take(f'{block}LayerNorm_1.scale', f'{base}/_output_layer_norm/gamma',
         (h,))
    take(f'{block}LayerNorm_1.bias', f'{base}/_output_layer_norm/beta',
         (h,))
  pooler = f'layer_with_weights-{4 + num_layers}'
  take('pooler.kernel', f'{pooler}/kernel', (h, h))
  take('pooler.bias', f'{pooler}/bias', (h,))
  unused = set(raw) - used
  if unused:
    raise ValueError(f'unmapped checkpoint variables: {sorted(unused)}')
  encoder = TransformerEncoder(
      vocab_size=cfg['vocab_size'],
      hidden_dim=h,
      num_layers=num_layers,
      num_heads=a,
      mlp_dim=i_dim,
      max_len=cfg['max_position_embeddings'],
      type_vocab_size=cfg.get('type_vocab_size', 2),
      dropout=dropout,
  )
  encoder.load_state_dict(params)
  return encoder, params
