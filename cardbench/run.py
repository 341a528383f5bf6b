"""Runs one cell of ``BENCHMARK.json`` once on the card.

  python -m cardbench.run --workload <name> --seed <n> --seconds <s> \\
      --trace <0|1>

from the root of a checkout. Prints the result as one JSON line, last on
standard output; the numbers compared for ``correct`` go last to standard
error too, each beside its limit. Exits non-zero with no result where
there is no card, fewer cards than the cell asks for, or where JAX or the
JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

STARTED = time.time()
# Build and kernel caches at fixed paths inside the checkout, Python's
# bytecode among them: the imports of torch and the port then compile once
# a checkout, not once a run.
CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), '.cardbench_cache')
sys.pycache_prefix = os.path.join(CACHE, 'pycache')


def process_start() -> float:
  """When this process started, on the ``time.time()`` clock (Linux: from
  /proc; elsewhere the import of this module)."""
  try:
    with open('/proc/self/stat') as f:
      fields = f.read().rsplit(')', 1)[1].split()
    ticks = int(fields[19])                       # field 22: starttime
    with open('/proc/uptime') as f:
      uptime = float(f.read().split()[0])
    return time.time() - (uptime - ticks / os.sysconf('SC_CLK_TCK'))
  except (OSError, ValueError, IndexError):
    return STARTED


# Top-level module names that no run may hold: JAX, flax, and the JAX
# package the port was made from (compared whole: the port's own name
# begins with it).
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'ranking_tpu')


def forbidden_modules():
  return sorted({n.split('.')[0] for n in list(sys.modules)}
                & set(FORBIDDEN))


def _finite(tree):
  """The result with every non-finite number as null (strict JSON)."""
  if isinstance(tree, dict):
    return {k: _finite(v) for k, v in tree.items()}
  if isinstance(tree, list):
    return [_finite(v) for v in tree]
  if isinstance(tree, float) and not math.isfinite(tree):
    return None
  return tree


def _cache_dirs() -> None:
  os.environ['TRITON_CACHE_DIR'] = os.path.join(CACHE, 'triton')
  os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(CACHE, 'torch_extensions')
  os.environ.setdefault('USE_FLAX', '0')


def main(argv=None) -> int:
  p = argparse.ArgumentParser()
  p.add_argument('--workload', required=True)
  p.add_argument('--seed', type=int, required=True)
  p.add_argument('--seconds', type=float, required=True)
  p.add_argument('--trace', type=int, choices=(0, 1), default=0)
  args = p.parse_args(argv)

  started = process_start()
  _cache_dirs()
  from cardbench import harness
  import torch
  bench = harness.benchmark()
  w = harness.workload(bench, args.workload)
  if not torch.cuda.is_available():
    print('cardbench: no CUDA device', file=sys.stderr)
    return 2
  if torch.cuda.device_count() < w['chips']:
    print(f"cardbench: {w['name']} needs {w['chips']} cards, "
          f'{torch.cuda.device_count()} present', file=sys.stderr)
    return 2
  build = os.path.join(harness.ROOT, 'ranking_tpu_torch', 'ops', 'cuda',
                       '_build')
  warm = os.path.isdir(build) and any(n.endswith('.so')
                                      for n in os.listdir(build))
  ctx = harness.make_ctx(bench, args.workload, args.seed, args.seconds,
                         bool(args.trace), 'cuda')
  result = harness.run(bench, ctx, harness.limits_of(args.workload), started,
                       build_dir_warm=warm)
  found = forbidden_modules()
  if found:
    print(f'cardbench: loaded in this process: {found}', file=sys.stderr)
    return 3
  for name, c in result['checks'].items():
    print(f"check {name} {c['value']!r} limit {c['limit']!r}",
          file=sys.stderr)
  print(json.dumps(_finite(result), allow_nan=False))
  return 0


if __name__ == '__main__':
  sys.exit(main())
