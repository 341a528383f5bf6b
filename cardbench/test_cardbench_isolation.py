"""What the benchmark loads: no JAX and no JAX package after a run, and a
reference that imports nothing of the program.

Run: ``python -m pytest cardbench/test_cardbench_isolation.py``.
"""

import ast
import glob
import os
import shutil
import subprocess
import sys

from cardbench import harness, run

REFERENCE = os.path.join(harness.HERE, 'reference')

_DRY_RUN = """
import sys, time
from cardbench import harness, small, run
from ranking_tpu_torch.ops.cuda import fused_bn
fused_bn.set_enabled(True)
for cell in [w['name'] for w in harness.benchmark()['workloads']]:
  bench, ctx = small.ctx(cell, seconds=0.2)
  harness.run(bench, ctx, harness.limits_of(cell), time.time())
print(run.forbidden_modules())
"""


def _python(code, cwd=harness.ROOT):
  env = dict(os.environ)
  env.pop('JAX_PLATFORMS', None)
  return subprocess.run([sys.executable, '-c', code], cwd=cwd, env=env,
                        capture_output=True, text=True, timeout=300)


def test_no_jax_and_no_jax_package_after_a_dry_run_of_every_cell():
  proc = _python(_DRY_RUN)
  assert proc.returncode == 0, proc.stderr[-3000:]
  assert proc.stdout.strip().splitlines()[-1] == '[]'


def test_forbidden_names_are_compared_whole(monkeypatch):
  import types
  modules = {n: m for n, m in sys.modules.items()
             if n.split('.')[0] not in run.FORBIDDEN}
  monkeypatch.setattr(sys, 'modules', modules)
  modules['ranking_tpu_torch.data'] = types.ModuleType('x')
  modules['jaxtyping'] = types.ModuleType('x')
  assert run.forbidden_modules() == []
  modules['ranking_tpu.data'] = types.ModuleType('x')
  modules['jax'] = types.ModuleType('x')
  assert run.forbidden_modules() == ['jax', 'ranking_tpu']


def test_the_reference_imports_nothing_of_the_program():
  for path in glob.glob(os.path.join(REFERENCE, '*.py')):
    with open(path) as f:
      tree = ast.parse(f.read())
    for node in ast.walk(tree):
      names = ([a.name for a in node.names] if isinstance(node, ast.Import)
               else [node.module or ''] if isinstance(node, ast.ImportFrom)
               else [])
      for name in names:
        assert name.split('.')[0] not in ('ranking_tpu_torch', 'ranking_tpu',
                                          'jax', 'flax'), (path, name)
  proc = _python('import sys\n'
                 'import cardbench.reference.dnn, cardbench.reference.encoder'
                 ', cardbench.reference.ranking, cardbench.reference.train\n'
                 "print(sorted(n for n in sys.modules "
                 "if n.split('.')[0].startswith('ranking_tpu')))")
  assert proc.returncode == 0, proc.stderr[-3000:]
  assert proc.stdout.strip() == '[]'


def test_a_run_without_a_card_or_without_the_program_prints_no_result(
    tmp_path):
  args = ['-m', 'cardbench.run', '--workload', 'tfr_bert.serve_rerank',
          '--seed', '1', '--seconds', '1', '--trace', '0']
  proc = subprocess.run([sys.executable, *args], cwd=harness.ROOT,
                        capture_output=True, text=True, timeout=300)
  assert proc.returncode != 0 and proc.stdout == ''
  shutil.copy(os.path.join(harness.ROOT, 'BENCHMARK.json'), tmp_path)
  shutil.copytree(harness.HERE, tmp_path / 'cardbench',
                  ignore=shutil.ignore_patterns('__pycache__'))
  proc = subprocess.run([sys.executable, *args], cwd=tmp_path,
                        capture_output=True, text=True, timeout=300)
  assert proc.returncode != 0 and proc.stdout == ''
