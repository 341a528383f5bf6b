"""ctypes bindings of the native data library: the batch decoder
(``decoder.cc``), the streaming loader (``loader.cc``), the LIBSVM parser
(``libsvm.cc``) and CRC-32C (``crc32c.cc``, for checkpoint tensors).

The port's copy of ``ranking_tpu/data/native``, with ``crc32c`` added. The
sources link into one library, built with ``g++`` at first use into
``_build/`` (git-ignored) as ``libranking_data_<hash>.so``, the hash
covering the sources and the flags: compiled to a private temp name, then
published by an atomic rename, so that a concurrent process never loads
half a file, and under a file lock, so that concurrent test workers share
one build. A failed build or load raises
``NativeBuildError``; nothing falls back to the Python parsers.
``decode_supported`` and ``loader_supported`` are the side-effect-free
checks of which specs the decoder and the loader take.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import weakref
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = tuple(os.path.join(_DIR, name)
              for name in ('decoder.cc', 'loader.cc', 'libsvm.cc',
                           'crc32c.cc'))
BUILD_DIR = os.path.join(_DIR, '_build')
_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17', '-pthread')

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# Calls of load_libsvm_lists in this process, so that a run can show which
# parser it went through.
parses = 0


class NativeBuildError(RuntimeError):
  """No C++ compiler, or it refused the sources, or the library would not
  load."""


class FeatureSpecStruct(ctypes.Structure):
  """``FeatureSpec`` of decoder.cc and loader.cc."""
  _fields_ = [
      ('name', ctypes.c_char_p),
      ('kind', ctypes.c_int32),
      ('size', ctypes.c_int32),
      ('buckets', ctypes.c_int64),
      ('fout', ctypes.POINTER(ctypes.c_float)),
      ('iout', ctypes.POINTER(ctypes.c_int32)),
      ('default_value', ctypes.c_float),
      # int64 values decode at full width (no float/int32 narrowing).
      ('lout', ctypes.POINTER(ctypes.c_int64)),
      # Fixed kinds: per row, the values of the spec's list type, or -1
      # for values of another type only; ``check_presence`` turns these
      # into the plain parser's errors.
      ('present', ctypes.POINTER(ctypes.c_int32)),
      # Vocabulary-table handle (rt_vocab_create) for KIND_VARLEN_VOCAB.
      ('vocab', ctypes.c_void_p),
      # Fixed example kinds: per record, the worst count among the
      # documents past list_size, which the plain parser checks too.
      ('overflow', ctypes.POINTER(ctypes.c_int32)),
  ]


KIND_FIXED_FLOAT = 0
KIND_FIXED_INT64 = 1
KIND_VARLEN_INT64 = 2
KIND_VARLEN_HASHED = 3
KIND_VARLEN_VOCAB = 4

_DECODERS = {'example_list_with_context': 'rt_decode_elwc_batch',
             'sequence_example': 'rt_decode_seq_batch',
             'example_in_example': 'rt_decode_eie_batch',
             'tf_example': 'rt_decode_example_batch'}
_LISTWISE = ('example_list_with_context', 'sequence_example',
             'example_in_example')


def library_path() -> str:
  digest = hashlib.sha256(' '.join(_FLAGS).encode())
  for src in _SRCS:
    with open(src, 'rb') as f:
      digest.update(f.read())
  return os.path.join(BUILD_DIR,
                      f'libranking_data_{digest.hexdigest()[:16]}.so')


def _build(path: str) -> None:
  compiler = shutil.which('g++') or shutil.which('c++')
  if compiler is None:
    raise NativeBuildError('no C++ compiler (g++ or c++) on PATH; the '
                           'native data library builds at first use')
  os.makedirs(os.path.dirname(path), exist_ok=True)
  tmp = f'{path}.{os.getpid()}.{threading.get_ident()}.tmp'
  try:
    proc = subprocess.run([compiler, *_FLAGS, '-o', tmp, *_SRCS],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
      raise NativeBuildError(f'{compiler} failed on the native data sources '
                             f'(exit {proc.returncode}):\n{proc.stderr}')
    os.replace(tmp, path)
  finally:
    if os.path.exists(tmp):
      os.unlink(tmp)


def _declare(lib: ctypes.CDLL) -> None:
  spec_p = ctypes.POINTER(FeatureSpecStruct)
  i32_p, i64_p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
  recs_p = ctypes.POINTER(ctypes.c_char_p)
  for name in _DECODERS.values():
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = [recs_p, i64_p, ctypes.c_int, ctypes.c_int, spec_p,
                   ctypes.c_int, spec_p, ctypes.c_int, i32_p]
  lib.rt_scan_tfrecord.restype = ctypes.c_int64
  lib.rt_scan_tfrecord.argtypes = [ctypes.c_char_p, ctypes.c_int64, i64_p,
                                   i64_p, ctypes.c_int64]
  lib.rt_elwc_sizes.restype = ctypes.c_int
  lib.rt_elwc_sizes.argtypes = [recs_p, i64_p, ctypes.c_int, i32_p]
  lib.rt_vocab_create.restype = ctypes.c_void_p
  lib.rt_vocab_create.argtypes = [recs_p, i64_p, ctypes.c_int64,
                                  ctypes.c_int64]
  lib.rt_vocab_free.restype = None
  lib.rt_vocab_free.argtypes = [ctypes.c_void_p]
  lib.rt_loader_create.restype = ctypes.c_void_p
  lib.rt_loader_create.argtypes = [
      recs_p, ctypes.c_int, spec_p, ctypes.c_int, spec_p, ctypes.c_int,
      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
      ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
      ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_char_p]
  lib.rt_loader_cache_state.restype = ctypes.c_int
  lib.rt_loader_cache_state.argtypes = [ctypes.c_void_p]
  lib.rt_loader_submit.restype = ctypes.c_int
  lib.rt_loader_submit.argtypes = [ctypes.c_void_p, spec_p, ctypes.c_int,
                                   spec_p, ctypes.c_int, i32_p]
  lib.rt_loader_wait.restype = ctypes.c_int
  lib.rt_loader_wait.argtypes = [ctypes.c_void_p]
  lib.rt_loader_destroy.restype = None
  lib.rt_loader_destroy.argtypes = [ctypes.c_void_p]
  lib.rt_libsvm_parse.restype = ctypes.c_void_p
  lib.rt_libsvm_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64]
  lib.rt_libsvm_num_queries.restype = ctypes.c_int64
  lib.rt_libsvm_num_queries.argtypes = [ctypes.c_void_p]
  lib.rt_libsvm_num_bad.restype = ctypes.c_int64
  lib.rt_libsvm_num_bad.argtypes = [ctypes.c_void_p]
  lib.rt_libsvm_fill.restype = None
  lib.rt_libsvm_fill.argtypes = [
      ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
      ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
  lib.rt_libsvm_qid.restype = ctypes.c_int
  lib.rt_libsvm_qid.argtypes = [
      ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int]
  lib.rt_libsvm_free.restype = None
  lib.rt_libsvm_free.argtypes = [ctypes.c_void_p]
  lib.rt_crc32c.restype = ctypes.c_uint32
  lib.rt_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32]


def crc32c(data) -> int:
  """CRC-32C of a bytes-like object (``data.tfrecord.crc32c``'s value)."""
  view = memoryview(data).cast('B')
  buf = np.frombuffer(view, np.uint8) if view.nbytes else np.zeros(1, np.uint8)
  return int(load().rt_crc32c(buf.ctypes.data, view.nbytes, 0))


def load() -> ctypes.CDLL:
  """The loaded library, built on first use. Concurrent processes (test
  workers) wait on a file lock for the one that builds it."""
  global _lib
  with _lock:
    if _lib is not None:
      return _lib
    path = library_path()
    if not os.path.exists(path):
      os.makedirs(os.path.dirname(path), exist_ok=True)
      with open(os.path.join(os.path.dirname(path), 'build.lock'), 'w') as f:
        fcntl.flock(f, fcntl.LOCK_EX)  # released when the file closes
        if not os.path.exists(path):
          _build(path)
    try:
      lib = ctypes.CDLL(path)
    except OSError as e:
      raise NativeBuildError(f'cannot load {path}: {e}') from e
    _declare(lib)
    _lib = lib
    return lib


# --- LIBSVM -----------------------------------------------------------------


def load_libsvm_lists(path: str, list_size: int, num_features: int,
                      padding_label: float = -1.0
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
  """Native LIBSVM loader; the contract of
  ``data.libsvm.load_libsvm_lists``. Raises ValueError on malformed rows
  (a missing qid or a bad feature token), as the Python loader does."""
  global parses
  lib = load()
  with open(path, 'rb') as f:
    data = f.read()
  handle = lib.rt_libsvm_parse(data, len(data))
  try:
    n_bad = lib.rt_libsvm_num_bad(handle)
    if n_bad:
      raise ValueError(
          f'{n_bad} malformed LIBSVM row(s) in {path} (missing qid or '
          f'bad feature token)')
    nq = lib.rt_libsvm_num_queries(handle)
    features = np.empty((nq, list_size, num_features), np.float32)
    labels = np.empty((nq, list_size), np.float32)
    lib.rt_libsvm_fill(
        handle, list_size, num_features, padding_label,
        features.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    buf = ctypes.create_string_buffer(256)
    qids = []
    for i in range(nq):
      lib.rt_libsvm_qid(handle, i, buf, 256)
      qids.append(buf.value.decode())
  finally:
    lib.rt_libsvm_free(handle)
  parses += 1
  return features, labels, np.asarray(qids)


# --- specs ------------------------------------------------------------------


def _native_kind(name: str, spec) -> Tuple[int, int]:
  """(kind, values a row) of a spec the native code decodes; ValueError
  naming the reason for one it does not."""
  from ranking_tpu_torch.data import parsers
  if isinstance(spec, parsers.FixedLenFeature):
    if spec.dtype == 'float32':
      kind = KIND_FIXED_FLOAT
    elif spec.dtype == 'int64':
      kind = KIND_FIXED_INT64
    else:
      raise ValueError(f'{name!r}: fixed-len {spec.dtype} is not decoded '
                       'natively')
    return kind, int(np.prod(spec.shape)) if spec.shape else 1
  if not isinstance(spec, parsers.VarLenFeature):
    raise ValueError(f'{name!r}: unknown spec {spec!r}')
  if spec.max_len is None:
    raise ValueError(f'{name!r}: native varlen decode requires max_len')
  if spec.pad_value != -1:
    raise ValueError(f'{name!r}: native varlen decode pads with -1, not '
                     f'{spec.pad_value!r}')
  if spec.dtype == 'int64':
    return KIND_VARLEN_INT64, spec.max_len
  if spec.dtype != 'string':
    raise ValueError(f'{name!r}: native varlen {spec.dtype} is not decoded')
  if spec.vocab is not None:
    if spec.vocab.size > 2**31 - 1:
      raise ValueError(f'{name!r}: vocab size {spec.vocab.size} exceeds '
                       'int32 ids')
    return KIND_VARLEN_VOCAB, spec.max_len
  if not spec.hash_buckets:
    raise ValueError(f'{name!r}: a string feature needs vocab or '
                     'hash_buckets')
  if spec.hash_buckets > 2**31 - 1:
    raise ValueError(f'{name!r}: hash_buckets {spec.hash_buckets} exceeds '
                     'int32 ids')
  return KIND_VARLEN_HASHED, spec.max_len


def _specs_ok(*spec_maps) -> bool:
  try:
    for spec_map in spec_maps:
      for name, spec in spec_map.items():
        _native_kind(name, spec)
  except ValueError:
    return False
  return True


def decode_supported(context_spec, example_spec,
                     data_format: str = 'example_list_with_context',
                     list_size: Optional[int] = None) -> bool:
  """True iff ``decode_elwc_batch`` takes these specs, format and list
  size: the check behind ``parsers.parse``. Builds nothing."""
  return (data_format in _DECODERS and list_size is not None
          and _specs_ok(context_spec, example_spec))


def loader_supported(context_spec, example_spec,
                     data_format: str = 'example_list_with_context',
                     list_size: Optional[int] = None) -> bool:
  """True iff ``NativeLoader`` serves these specs: ELWC or SequenceExample
  at a fixed list size. The check behind the dataset builder's 'auto'
  engine. Builds nothing."""
  return (data_format in _LOADER_FORMATS and list_size is not None
          and _specs_ok(context_spec, example_spec))


_LOADER_FORMATS = {'example_list_with_context': 0, 'sequence_example': 1}


def _loader_format(data_format: str) -> int:
  if data_format not in _LOADER_FORMATS:
    raise ValueError(
        f'NativeLoader supports example_list_with_context and '
        f'sequence_example; got {data_format!r}')
  return _LOADER_FORMATS[data_format]


def _vocab_handle(lib, vocab) -> int:
  """The C++ lookup table of a ``parsers.Vocabulary``, built once and
  cached on it, freed when it is collected. Immutable, so decode threads
  share it; specs hold their Vocabulary, which keeps it alive."""
  handle = getattr(vocab, '_native_handle', None)
  if handle is not None:
    return handle
  tokens = vocab.tokens
  n = len(tokens)
  toks = (ctypes.c_char_p * max(1, n))(*tokens)
  lens = (ctypes.c_int64 * max(1, n))(*[len(t) for t in tokens])
  handle = lib.rt_vocab_create(toks, lens, n, vocab.num_oov_buckets)
  vocab._native_handle = handle
  weakref.finalize(vocab, lib.rt_vocab_free, handle)
  return handle


def _structs(lib, spec_map):
  """The FeatureSpecStruct array of a spec map (sorted by name), without
  output pointers."""
  from ranking_tpu_torch.data import parsers
  structs = []
  for name in sorted(spec_map):
    spec = spec_map[name]
    kind, size = _native_kind(name, spec)
    st = FeatureSpecStruct()
    st.name = name.encode()
    st.kind, st.size = kind, size
    if isinstance(spec, parsers.FixedLenFeature):
      st.default_value = float(
          0.0 if spec.default_value is None else spec.default_value)
    elif kind == KIND_VARLEN_VOCAB:
      st.vocab = _vocab_handle(lib, spec.vocab)
    elif kind == KIND_VARLEN_HASHED:
      st.buckets = spec.hash_buckets
    structs.append(st)
  return (FeatureSpecStruct * max(1, len(structs)))(*structs)


def _alloc(spec_map, structs, rows: int, records: Optional[int]):
  """Fresh output arrays for ``rows`` rows, pointed to by ``structs``:
  name -> (values, spec, presence, overflow). ``records`` (listwise
  example specs) sizes the overflow counts of the fixed kinds.

  ``np.empty`` is safe: the decoder fills every row it returns (defaults
  first), and only rows backed by records are read.
  """
  outputs = {}
  for st, name in zip(structs, sorted(spec_map)):
    presence = overflow = None
    if st.kind == KIND_FIXED_FLOAT:
      arr = np.empty((rows, st.size), np.float32)
      st.fout = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    elif st.kind in (KIND_FIXED_INT64, KIND_VARLEN_INT64):
      arr = np.empty((rows, st.size), np.int64)
      st.lout = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    else:
      arr = np.empty((rows, st.size), np.int32)
      st.iout = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    if st.kind in (KIND_FIXED_FLOAT, KIND_FIXED_INT64):
      presence = np.empty(rows, np.int32)
      st.present = presence.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
      if records is not None:
        overflow = np.empty(records, np.int32)
        st.overflow = overflow.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    outputs[name] = (arr, spec_map[name], presence, overflow)
  return outputs


def check_presence(outputs, valid_rows=None, valid_records=None) -> None:
  """Raises the plain parser's errors (``parsers._extract``) from the
  native counts: a required fixed feature (default None) absent from a
  real row, a present one with the wrong value count, or one that holds
  values of another type only. ``valid_rows`` / ``valid_records`` are bool
  masks of the rows and records backed by data (None = all)."""
  for name, (_arr, spec, presence, overflow) in outputs.items():
    if presence is None:
      continue
    size = int(np.prod(spec.shape)) if spec.shape else 1
    counts = presence if valid_rows is None else presence[valid_rows]
    if overflow is not None:
      counts = np.concatenate([counts, overflow if valid_records is None
                               else overflow[valid_records]])
    if (counts < 0).any():
      raise ValueError(
          f'Feature {name!r}: stored value type does not match spec '
          f'dtype {spec.dtype!r} (tf.io.parse_example raises here too)')
    if spec.default_value is None and (counts == 0).any():
      raise ValueError(f'Missing required feature {name!r}')
    bad = (counts != 0) & (counts != size)
    if bad.any():
      raise ValueError(f'Feature {name!r}: got {int(counts[bad][0])} '
                       f'values, expected {size}')


def _finalize(outputs, n: int, list_size: Optional[int]):
  """name -> array: [n, ...] for the context, [n, list_size, ...] for the
  examples; token ids as int64."""
  from ranking_tpu_torch.data import parsers
  out = {}
  rows = n if list_size is None else n * list_size
  for name, (arr, spec, _presence, _overflow) in outputs.items():
    a = arr[:rows]
    if isinstance(spec, parsers.FixedLenFeature):
      a = a.reshape((rows,) + tuple(spec.shape))
    elif a.dtype != np.int64:
      a = a.astype(np.int64)
    if list_size is not None:
      a = a.reshape((n, list_size) + a.shape[1:])
    out[name] = a
  return out


# --- one-shot decode --------------------------------------------------------


def _records(records):
  records = [bytes(r) for r in records]
  n = len(records)
  return (records, (ctypes.c_char_p * max(1, n))(*records),
          (ctypes.c_int64 * max(1, n))(*[len(r) for r in records]))


def read_tfrecord_payloads(path: str):
  """The payloads of a TFRecord file, by a native scan of its framing
  (no checksums). Raises ValueError on a file that does not end at a
  record boundary."""
  lib = load()
  with open(path, 'rb') as f:
    data = f.read()
  max_records = len(data) // 16 + 16
  offsets = np.zeros(max_records, np.int64)
  lengths = np.zeros(max_records, np.int64)
  n = lib.rt_scan_tfrecord(
      data, len(data),
      offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
      lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), max_records)
  if n < 0:
    raise ValueError(f'{path}: truncated or corrupt TFRecord framing')
  return [data[offsets[i]:offsets[i] + lengths[i]] for i in range(n)]


def decode_elwc_batch(records, list_size: int, context_spec, example_spec,
                      data_format: str = 'example_list_with_context'):
  """Decodes serialized records of ``data_format`` natively into a
  ``parsers.ParsedLists``: the plain parser's arrays, bit for bit, and its
  errors. ValueError for specs ``decode_supported`` rejects."""
  from ranking_tpu_torch.data import parsers
  if data_format not in _DECODERS:
    raise ValueError(f'Unknown data_format {data_format!r}; '
                     f'expected one of {sorted(_DECODERS)}')
  lib = load()
  records, recs, lens = _records(records)
  n = len(records)
  ctx_structs = _structs(lib, context_spec)
  ex_structs = _structs(lib, example_spec)
  ctx_out = _alloc(context_spec, ctx_structs, n, None)
  ex_out = _alloc(example_spec, ex_structs, n * list_size,
                  n if data_format in _LISTWISE else None)
  sizes = np.zeros(n, np.int32)
  rc = getattr(lib, _DECODERS[data_format])(
      recs, lens, n, list_size, ctx_structs, len(context_spec), ex_structs,
      len(example_spec), sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
  if rc != 0:
    raise ValueError(f'malformed {data_format} record in native decode')
  mask = np.arange(list_size)[None, :] < sizes[:, None]
  check_presence(ctx_out)
  check_presence(ex_out, valid_rows=mask.reshape(-1))
  return parsers.ParsedLists(context=_finalize(ctx_out, n, None),
                             examples=_finalize(ex_out, n, list_size),
                             sizes=sizes, mask=mask)


def elwc_sizes(records) -> np.ndarray:
  """[B] int32 list lengths of serialized ELWC protos (a C++ walk of the
  top level, no feature decoding). ValueError on a malformed record."""
  lib = load()
  records, recs, lens = _records(records)
  sizes = np.zeros(len(records), np.int32)
  rc = lib.rt_elwc_sizes(recs, lens, len(records),
                         sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
  if rc != 0:
    raise ValueError('malformed ELWC record in native size scan')
  return sizes


def cache_file_for(cache_dir, paths, context_spec, example_spec,
                   list_size, data_format='example_list_with_context'):
  """The spill file of the decoded-once epoch cache (loader.cc ``Cache``):
  ``cache_dir/rtcache-<hex>.bin``, the name a content fingerprint of the
  file list and of everything that shapes a decoded payload (every spec
  field, vocabulary tokens and OOV buckets, hash buckets, list size,
  format), so that another recipe gets a fresh spill. The C++ side checks
  the structure and each file's size and mtime again when it opens one.
  Creates ``cache_dir``."""
  from ranking_tpu_torch.data import parsers
  h = hashlib.sha256()
  h.update(f'{data_format}|{list_size}|'.encode())
  for p in paths:
    h.update(str(p).encode() + b'\x00')
  for tag, spec_map in (('ctx', context_spec), ('ex', example_spec)):
    for name in sorted(spec_map):
      spec = spec_map[name]
      h.update(f'|{tag}:{name}:'.encode())
      if isinstance(spec, parsers.FixedLenFeature):
        h.update(
            f'F{spec.shape}:{spec.dtype}:{spec.default_value!r}'.encode())
      else:
        h.update(f'V{spec.dtype}:{spec.max_len}:{spec.pad_value!r}:'
                 f'{spec.hash_buckets}'.encode())
        if spec.vocab is not None:
          h.update(str(spec.vocab.num_oov_buckets).encode())
          for t in spec.vocab.tokens:
            h.update(t + b'\x00')
  os.makedirs(cache_dir, exist_ok=True)
  return os.path.join(cache_dir, f'rtcache-{h.hexdigest()[:24]}.bin')


# --- the streaming loader ---------------------------------------------------


class NativeLoader:
  """Streaming native loader: C++ threads own reading, shuffling, decoding
  and batching (loader.cc). Iterates ``parsers.ParsedLists``.

  One reader thread walks the files, scans the TFRecord framing and keeps
  the seeded shuffle buffer, so the record order is a function of the seed
  alone; ``num_threads`` decode workers write each batch straight into a
  fresh set of numpy buffers that this object registers ahead of use, and
  a reorder buffer returns the batches in assembly order, whatever the
  thread count. Each set is handed out once and never reused, so a batch
  stays valid while the consumer holds it. ``skip_batches`` drops the
  leading record batches undecoded; ``cache_path`` turns on the
  decoded-once epoch cache (name it with ``cache_file_for``). A cache that
  cannot be opened, locked (another loader builds it, or reads it while
  this one would rebuild it) or written raises ``ValueError``: the loader
  never runs uncached in its place.
  """

  def __init__(self, paths, context_spec, example_spec, batch_size,
               list_size, shuffle=True, shuffle_buffer=1000, epochs=1,
               drop_remainder=True, seed=0,
               data_format='example_list_with_context', num_threads=None,
               skip_batches=0, cache_path=None):
    self._handle = None
    fmt = _loader_format(data_format)
    lib = load()
    self._lib = lib
    self.paths = list(paths)
    self.batch_size = batch_size
    self.list_size = list_size
    self.context_spec = dict(context_spec)
    self.example_spec = dict(example_spec)
    self._ctx_structs = _structs(lib, self.context_spec)
    self._ex_structs = _structs(lib, self.example_spec)
    if num_threads is None:
      num_threads = min(8, os.cpu_count() or 1)
    self.num_threads = max(1, int(num_threads))
    # Enough queued work to keep every decoder busy across consumer
    # hiccups without unbounded buffering.
    ring_capacity = 2 * self.num_threads + 2
    c_paths = (ctypes.c_char_p * max(1, len(paths)))(
        *[str(p).encode() for p in paths])
    self._handle = lib.rt_loader_create(
        c_paths, len(paths), self._ctx_structs, len(self.context_spec),
        self._ex_structs, len(self.example_spec), batch_size, list_size,
        int(shuffle), shuffle_buffer, 0 if epochs is None else epochs,
        int(drop_remainder), seed, ring_capacity, fmt, self.num_threads,
        int(skip_batches), str(cache_path).encode() if cache_path else None)
    # The buffer ring: sets registered ahead of consumption, which the
    # decode workers fill in parallel; it is also the loader's
    # backpressure (a worker cannot decode batch k before set k is
    # registered).
    self._ring = collections.deque()
    self._ended = False
    if self.cache_state == 'failed':
      self.close()
      raise ValueError(
          f'dataset cache {cache_path}: cannot be opened, locked or written '
          '(another loader holds its lock, or the path is unwritable)')
    for _ in range(self.num_threads + 2):
      self._submit_set()

  def _submit_set(self):
    ctx_out = _alloc(self.context_spec, self._ctx_structs, self.batch_size,
                     None)
    ex_out = _alloc(self.example_spec, self._ex_structs,
                    self.batch_size * self.list_size, self.batch_size)
    sizes = np.zeros(self.batch_size, np.int32)
    # rt_loader_submit copies the pointers out of the structs at once.
    self._lib.rt_loader_submit(
        self._handle, self._ctx_structs, len(self.context_spec),
        self._ex_structs, len(self.example_spec),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    self._ring.append((ctx_out, ex_out, sizes))

  def __iter__(self):
    return self

  @property
  def cache_state(self) -> str:
    """Epoch-cache engagement, set when the loader is made: 'off' (none
    asked for), 'build' (decoding and writing the spill), 'read'
    (streaming a complete spill; the proto files are not opened) or
    'failed' (a slot could not be written: the stream raises)."""
    if not self._handle:
      return 'off'
    return {-1: 'failed', 0: 'off', 1: 'build',
            2: 'read'}[self._lib.rt_loader_cache_state(self._handle)]

  def __next__(self):
    from ranking_tpu_torch.data import parsers
    if self._ended or not self._handle:
      raise StopIteration
    n = self._lib.rt_loader_wait(self._handle)
    if n < 0:
      failed = self.cache_state == 'failed'
      self.close()
      if failed:
        raise ValueError('dataset cache: a decoded record could not be '
                         'written to the spill (disk full?)')
      raise ValueError(
          f'native loader stream error over {self.paths}: a record failed '
          'to decode (the data is corrupt; the one-shot parser raises for '
          'the same input), an input file is unreadable or does not end at '
          'a record boundary (training on the partial corpus would be '
          'silent data loss), or an epoch held no record while more were '
          'asked for (the stream would never yield one)')
    if n == 0:
      self._ended = True
      self.close()  # releases the threads and the cache's lock
      raise StopIteration
    ctx_out, ex_out, sizes = self._ring.popleft()
    self._submit_set()  # keep the decode pipeline primed
    sizes = sizes[:n]
    mask = np.arange(self.list_size)[None, :] < sizes[:, None]
    valid = np.zeros((self.batch_size, self.list_size), bool)
    valid[:n] = mask
    records = np.arange(self.batch_size) < n
    check_presence(ctx_out, valid_rows=records)
    check_presence(ex_out, valid_rows=valid.reshape(-1),
                   valid_records=records)
    return parsers.ParsedLists(
        context=_finalize(ctx_out, n, None),
        examples=_finalize(ex_out, n, self.list_size),
        sizes=sizes, mask=mask)

  def close(self):
    if self._handle:
      # Destroy first: it joins the worker threads, after which no C++
      # thread can touch the ring's numpy buffers.
      self._lib.rt_loader_destroy(self._handle)
      self._handle = None
      self._ring.clear()

  def __del__(self):
    self.close()
