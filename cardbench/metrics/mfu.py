"""The model's share of the card's TF32 peak: the operations of the valid
documents and tokens of all the work the window did (a train step's
forward and backward, a request's forward; ``cardbench/work.py``), over
the window's time."""

from cardbench import peaks


def read(run):
  flops = run.counters.get('model_flops', 0.0)
  if not flops or not run.window_s:
    return None
  return 100.0 * flops / run.window_s / peaks.TF32_FLOPS
