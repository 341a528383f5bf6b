"""ctypes binding of the native LIBSVM parser (``libsvm.cc``).

The port's copy of the LIBSVM half of ``ranking_tpu/data/native``. The
library builds with ``g++`` at first use into ``_build/`` (git-ignored) as
``libranking_libsvm_<hash>.so``, the hash covering the source and the
flags: compiled to a private temp name, then published by an atomic rename,
so that a concurrent process never loads half a file. A failed build or
load raises ``NativeBuildError``; the caller that asked for the native
parser gets no quiet fall back to the Python one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, 'libsvm.cc')
BUILD_DIR = os.path.join(_DIR, '_build')
_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# Calls of load_libsvm_lists in this process, so that a run can show which
# parser it went through.
parses = 0


class NativeBuildError(RuntimeError):
  """No C++ compiler, or it refused ``libsvm.cc``, or the library would not
  load."""


def library_path() -> str:
  with open(_SRC, 'rb') as f:
    digest = hashlib.sha256(f.read() + ' '.join(_FLAGS).encode()
                            ).hexdigest()[:16]
  return os.path.join(BUILD_DIR, f'libranking_libsvm_{digest}.so')


def _build(path: str) -> None:
  compiler = shutil.which('g++') or shutil.which('c++')
  if compiler is None:
    raise NativeBuildError('no C++ compiler (g++ or c++) on PATH; the '
                           'native LIBSVM parser builds at first use')
  os.makedirs(BUILD_DIR, exist_ok=True)
  tmp = f'{path}.{os.getpid()}.tmp'
  try:
    proc = subprocess.run([compiler, *_FLAGS, '-o', tmp, _SRC],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
      raise NativeBuildError(f'{compiler} failed on libsvm.cc (exit '
                             f'{proc.returncode}):\n{proc.stderr}')
    os.replace(tmp, path)
  finally:
    if os.path.exists(tmp):
      os.unlink(tmp)


def load() -> ctypes.CDLL:
  """The loaded library, built on first use."""
  global _lib
  with _lock:
    if _lib is not None:
      return _lib
    path = library_path()
    if not os.path.exists(path):
      _build(path)
    try:
      lib = ctypes.CDLL(path)
    except OSError as e:
      raise NativeBuildError(f'cannot load {path}: {e}') from e
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
    _lib = lib
    return lib


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
