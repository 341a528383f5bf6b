"""One run of one cell: set-up, the measured window, the correctness check
and the result line, driven by ``BENCHMARK.json`` and the files it names.

A cell's configuration is ``configs/<config>.json`` (its ``family`` names
``families/<family>.py``), its traffic mix ``traffic/<traffic>.json``
(its ``kind`` names ``kinds/<kind>.py``), its limits
``limits/<workload>.json``, and each per-layer metric is read by
``metrics/<metric>.py``. Nothing here branches on a cell.
"""

from __future__ import annotations

import collections
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
import types
from typing import Any, Dict, Optional

import torch

from cardbench import core

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str):
  with open(path) as f:
    return json.load(f)


def benchmark(root: str = ROOT) -> Dict[str, Any]:
  return load_json(os.path.join(root, 'BENCHMARK.json'))


def workload(bench, name: str) -> Dict[str, Any]:
  for w in bench['workloads']:
    if w['name'] == name:
      return w
  raise SystemExit(f'no workload {name!r} in BENCHMARK.json; one of '
                   f"{[w['name'] for w in bench['workloads']]}")


def config_entry(bench, name: str) -> Dict[str, Any]:
  for c in bench['configs']:
    if c['name'] == name:
      return c
  raise SystemExit(f'no configuration {name!r} in BENCHMARK.json')


def stem(name: str) -> str:
  """A metric's name up to its first dot: what it measures, whatever the
  cells it is split over."""
  return name.split('.')[0]


def metric_reader(name: str):
  """The reader of a per-layer metric: ``metrics/<name>.py`` where it
  exists, else ``metrics/<stem>.py``."""
  path = os.path.join(HERE, 'metrics', f'{name}.py')
  if not os.path.exists(path):
    path = os.path.join(HERE, 'metrics', f'{stem(name)}.py')
  spec = importlib.util.spec_from_file_location(
      f'cardbench.metrics._{name.replace(".", "_")}', path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def end_to_end_of(bench, cell: str):
  return [m for m in bench['end_to_end']
          if cell in m.get('workloads', [cell])]


def per_layer_of(bench, cell: str):
  e2e = {m['name'] for m in end_to_end_of(bench, cell)}
  return [m for m in bench['per_layer']
          if (cell in m['workloads'] if 'workloads' in m
              else m['moves'] in e2e)]


@dataclasses.dataclass
class Ctx:
  cell: str
  config: Dict[str, Any]
  traffic: Dict[str, Any]
  family: types.ModuleType
  seed: int
  seconds: float
  trace: bool
  device: torch.device
  spans: core.Spans
  counters: Dict[str, float]


def make_ctx(bench, cell: str, seed: int, seconds: float, trace: bool,
             device, config=None, traffic=None) -> Ctx:
  """The context of a run; ``config`` and ``traffic`` stand in for the
  cell's files (the tests' small sizes)."""
  w = workload(bench, cell)
  if config is None:
    config = load_json(os.path.join(
        ROOT, config_entry(bench, w['config'])['file']))
  if traffic is None:
    traffic = load_json(os.path.join(HERE, 'traffic', f"{w['traffic']}.json"))
  family = importlib.import_module(f"cardbench.families.{config['family']}")
  return Ctx(cell, config, traffic, family, int(seed), float(seconds),
             bool(trace), torch.device(device), core.Spans(bool(trace)),
             collections.defaultdict(float))


def kind_of(ctx: Ctx) -> types.ModuleType:
  return importlib.import_module(f"cardbench.kinds.{ctx.traffic['kind']}")


def limits_of(cell: str) -> Dict[str, float]:
  return load_json(os.path.join(HERE, 'limits', f'{cell}.json'))['limits']


def run(bench, ctx: Ctx, limits: Optional[Dict[str, float]], started: float,
        build_dir_warm: Optional[bool] = None) -> Dict[str, Any]:
  """Sets up, measures, checks; returns the result line's object.
  ``started``: the process's start on the ``time.time()`` clock."""
  t_begin = time.time()
  cell = kind_of(ctx).Cell(ctx)
  t_inputs = time.time()
  cell.setup()
  win = core.Window(ctx.seconds, ctx.trace, ctx.device, ctx.counters)
  ctx.spans.times.clear()
  win.start()
  t_window = time.time()
  setup_s = t_window - started
  e2e, attempted, failed = cell.window(win)
  window_s = win.t1 - win.t0
  prog = cell.program_readings()
  cell.free()
  t_ref = time.time()
  values = cell.compare(prog, cell.reference_readings())
  print(f'cardbench: set-up {setup_s:.2f} s (to the harness '
        f'{t_begin - started:.2f}, inputs {t_inputs - t_begin:.2f}, program '
        f'{t_window - t_inputs:.2f}), window {window_s:.2f} s, reference '
        f'{time.time() - t_ref:.2f} s', file=sys.stderr)
  # The numbers the cell's limits file names are compared; ``limits``
  # None compares every number against no limit (the calibration).
  checks = {name: {'value': v, 'limit': (math.inf if limits is None
                                          else limits[name])}
            for name, v in values.items()
            if limits is None or name in limits}
  if limits is not None and set(limits) - set(checks):
    raise RuntimeError(f'no reading of {sorted(set(limits) - set(checks))}')
  correct = failed == 0 and attempted > 0 and all(
      math.isfinite(c['value']) and c['value'] <= c['limit']
      for c in checks.values())

  metrics = {}
  if not ctx.trace:
    e2e = dict(e2e, setup_s=setup_s)
    for m in end_to_end_of(bench, ctx.cell):
      # A kind reports a quantity by its stem; a metric split over cells
      # (``train_lists_per_s.bert``) takes the cell's.
      value = e2e.get(m['name'], e2e.get(stem(m['name'])))
      metrics[m['name']] = {'value': value, 'unit': m['unit']}
  else:
    info = types.SimpleNamespace(
        config=ctx.config, traffic=ctx.traffic, family=ctx.family,
        spans=ctx.spans, counters=dict(ctx.counters), window_s=window_s,
        trace=win.trace)
    for m in per_layer_of(bench, ctx.cell):
      value = metric_reader(m['name']).read(info)
      if value is not None:
        metrics[m['name']] = {'value': value, 'unit': m['unit']}
  device = {'platform': 'gpu' if ctx.device.type == 'cuda' else 'cpu',
            'kind': (torch.cuda.get_device_name(ctx.device)
                     if ctx.device.type == 'cuda' else 'cpu'),
            'count': 1, 'memory_peak_bytes': int(win.memory_peak)}
  out = {'correct': bool(correct), 'attempted': int(attempted),
         'failed': int(failed), 'metrics': metrics, 'device': device}
  if win.trace is not None:
    device['busy_s'] = win.trace.busy_s()
    device['window_s'] = win.trace.window_s
    out['breakdown'] = win.trace.breakdown()
  if build_dir_warm is not None:
    out['kernels_built_before'] = build_dir_warm
  out['checks'] = checks
  return out
