"""Builds the port's CUDA kernels from ``csrc/`` at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, ``_build/lib<name>_<hash>.so``, which is loaded with
``ctypes``. The hash covers the source, the headers (``csrc/*.cuh``) and the
compiler flags, so an edited source rebuilds and an unchanged one loads the
existing library. ``compile_libraries`` builds several sources at once, one
``nvcc`` process each. The
sources do not include PyTorch's headers, which keeps a build to seconds;
the wrappers pass ``data_ptr()``s and the current stream's handle.

A failed build raises: there is no fallback to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent import futures
from typing import Dict, List, Sequence

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), '_build')

# `-Xptxas -v`: each kernel's registers, shared memory and spills go to the
# log kept beside its library.
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_LIBS: Dict[str, ctypes.CDLL] = {}
# Seconds nvcc took for each library built by this process (by file name).
BUILD_SECONDS: Dict[str, float] = {}
_LOCK = threading.Lock()


class KernelBuildError(RuntimeError):
  """nvcc is missing or refused a kernel source."""


def nvcc_path() -> str:
  """The CUDA compiler that PyTorch's extension build would use."""
  from torch.utils import cpp_extension
  candidates = []
  if cpp_extension.CUDA_HOME:
    candidates.append(os.path.join(cpp_extension.CUDA_HOME, 'bin', 'nvcc'))
  found = shutil.which('nvcc')
  if found:
    candidates.append(found)
  for path in candidates:
    if os.path.isfile(path):
      return path
  raise KernelBuildError(
      'nvcc not found (set CUDA_HOME or put nvcc on PATH); the port\'s '
      'CUDA kernels build from source at first use')


def library_path(name: str, extra_flags: tuple = ()) -> str:
  """Where the library of ``csrc/<name>.cu`` lives for its current source."""
  with open(os.path.join(_CSRC, f'{name}.cu'), 'rb') as f:
    source = f.read()
  for header in sorted(os.listdir(_CSRC)):
    if header.endswith('.cuh'):
      with open(os.path.join(_CSRC, header), 'rb') as f:
        source += f.read()
  digest = hashlib.sha256(
      source + ' '.join(NVCC_FLAGS + tuple(extra_flags)).encode()
  ).hexdigest()[:16]
  return os.path.join(BUILD_DIR, f'lib{name}_{digest}.so')


def compile_library(name: str, extra_flags: tuple = ()) -> str:
  """Compiles ``csrc/<name>.cu`` unless its library exists; returns its path.

  ``extra_flags`` (e.g. ``('-lineinfo',)``) enter the hash, so a build
  with them never shadows the plain one.
  """
  path = library_path(name, extra_flags)
  if os.path.exists(path):
    return path
  os.makedirs(BUILD_DIR, exist_ok=True)
  tmp = f'{path}.{os.getpid()}.tmp'
  cmd: List[str] = [nvcc_path(), *NVCC_FLAGS, *extra_flags, '-o', tmp,
                    os.path.join(_CSRC, f'{name}.cu')]
  started = time.perf_counter()
  proc = subprocess.run(cmd, capture_output=True, text=True)
  BUILD_SECONDS[os.path.basename(path)] = time.perf_counter() - started
  if proc.returncode != 0:
    raise KernelBuildError(
        f'nvcc failed on {name}.cu (exit {proc.returncode}):\n'
        f'{proc.stdout}{proc.stderr}')
  if proc.stdout or proc.stderr:
    # ptxas -v and warnings: keep them beside the library.
    with open(path + '.log', 'w') as f:
      f.write(proc.stdout + proc.stderr)
  os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
  return path


def compile_libraries(names: Sequence[str]) -> List[str]:
  """Compiles several sources side by side; returns their library paths."""
  with futures.ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
    return list(pool.map(compile_library, names))


def load_library(name: str) -> ctypes.CDLL:
  """The loaded library of ``csrc/<name>.cu``, built on first use."""
  with _LOCK:
    lib = _LIBS.get(name)
    if lib is None:
      lib = ctypes.CDLL(compile_library(name))
      _LIBS[name] = lib
    return lib
