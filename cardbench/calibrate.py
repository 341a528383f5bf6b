"""Readings that the correctness limits are set from, on the card.

  python -m cardbench.calibrate --workload <name> --seconds <s> \\
      --seeds <n> ... [--control-seeds <n> ...] \\
      [--fault <name> --fault-seeds <n> ...] [--out <file.json>]

In one process: for each of ``--seeds``, a run of the cell (the program
against the reference; the numbers compared, its end-to-end metrics); for
each of ``--control-seeds``, the numbers the control (the reference through
TF32 in the program's place) and the faults planted in the reference give
against the reference, with no program run; for each of ``--fault-seeds``,
a run of the cell with the fault ``--fault`` planted in the program's timed
path (``faults.PROGRAM_FAULTS``). Prints one JSON line and writes it to
``--out``. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
  p = argparse.ArgumentParser()
  p.add_argument('--workload', required=True)
  p.add_argument('--seconds', type=float, default=3.0)
  p.add_argument('--seeds', type=int, nargs='*', default=[])
  p.add_argument('--control-seeds', type=int, nargs='*', default=[])
  p.add_argument('--fault', default=None)
  p.add_argument('--fault-seeds', type=int, nargs='*', default=[])
  p.add_argument('--device', default='cuda')
  p.add_argument('--out', default=None)
  args = p.parse_args(argv)
  from cardbench import faults, harness
  bench = harness.benchmark()

  def run(seed):
    ctx = harness.make_ctx(bench, args.workload, seed, args.seconds, False,
                           args.device)
    out = harness.run(bench, ctx, None, time.time())
    line = {'seed': seed, 'checks': {k: v['value'] for k, v in
                                     out['checks'].items()},
            'metrics': {k: v['value'] for k, v in out['metrics'].items()},
            'attempted': out['attempted'], 'failed': out['failed']}
    print(json.dumps(line), file=sys.stderr, flush=True)
    return line

  runs = [run(seed) for seed in args.seeds]
  faulted = []
  if args.fault_seeds:
    with faults.PROGRAM_FAULTS[args.fault]():
      faulted = [run(seed) for seed in args.fault_seeds]
  controls = []
  for seed in args.control_seeds:
    ctx = harness.make_ctx(bench, args.workload, seed, args.seconds, False,
                           args.device)
    cell = harness.kind_of(ctx).Cell(ctx)
    controls.append({'seed': seed, **cell.controls()})
    print(json.dumps(controls[-1]), file=sys.stderr, flush=True)
  line = json.dumps({'workload': args.workload, 'runs': runs,
                     'controls': controls, 'fault': args.fault,
                     'faulted': faulted})
  if args.out:
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
      f.write(line + '\n')
  print(line)
  return 0


if __name__ == '__main__':
  sys.exit(main())
