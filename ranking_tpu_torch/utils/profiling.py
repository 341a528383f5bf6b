"""Profiling and throughput instrumentation.

The port's copy of ``ranking_tpu/utils/profiling.py``: ``trace`` captures a
``torch.profiler`` trace of the host and, on CUDA, of the device (the JAX
package's ``jax.profiler`` trace), written as a Chrome trace that Perfetto
or chrome://tracing opens; ``StepTimer`` is a host-side step and
throughput meter.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch

from ranking_tpu_torch.utils.device import DeviceLike


@contextlib.contextmanager
def trace(log_dir: str, device: Optional[DeviceLike] = None,
          filename: str = 'trace.json') -> Iterator[torch.profiler.profile]:
  """Profiles the block and writes ``log_dir/filename``. The device's
  kernels are traced when ``device`` is CUDA (None: when a card is
  there); the trace ends after a synchronize, so that it holds the
  block's device work."""
  from torch.profiler import ProfilerActivity, profile
  cuda = (torch.cuda.is_available() if device is None
          else torch.device(device).type == 'cuda')
  activities = [ProfilerActivity.CPU]
  if cuda:
    activities.append(ProfilerActivity.CUDA)
  prof = profile(activities=activities)
  prof.start()
  try:
    yield prof
  finally:
    if cuda:
      torch.cuda.synchronize()
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, filename))


class StepTimer:
  """Streaming examples/s and step-latency meter."""

  def __init__(self, window: int = 100):
    self.window = window
    self.reset()

  def reset(self) -> None:
    self._t0 = time.perf_counter()
    self._steps = 0
    self._examples = 0
    self._recent = []

  def step(self, batch_size: int) -> None:
    now = time.perf_counter()
    self._recent.append((now, batch_size))
    if len(self._recent) > self.window:
      self._recent.pop(0)
    self._steps += 1
    self._examples += batch_size

  def rates(self) -> Dict[str, float]:
    now = time.perf_counter()
    total_dt = max(now - self._t0, 1e-9)
    out = {
        'steps_per_sec': self._steps / total_dt,
        'examples_per_sec': self._examples / total_dt,
    }
    if len(self._recent) >= 2:
      dt = max(self._recent[-1][0] - self._recent[0][0], 1e-9)
      n = sum(b for _, b in self._recent[1:])
      out['recent_examples_per_sec'] = n / dt
    return out
