"""What every cell's run shares: the measured window, the spans, the
device trace and its reading.

A run sets up, then measures for ``seconds``: the kind's loop calls
``Window.tick()`` between its units of work (a dispatch, a request, a
pass) and stops when it returns False. With ``trace`` the spans are on
(``Spans``, each also a ``torch.profiler.record_function`` range), and the
last ``TRACE_SECONDS`` of the window run under ``torch.profiler``: the
device's busy time, its kernels by name and its idle gaps come from there.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

# The traced part of a traced run's window: long enough for some dispatches
# of the slowest cell, short enough that reading the trace takes seconds.
TRACE_SECONDS = 3.0
SPAN_PREFIX = 'cardbench.'


class Spans:
  """Host-clock spans by name (seconds each), recorded only when on."""

  def __init__(self, on: bool):
    self.on = on
    self.times: Dict[str, List[float]] = collections.defaultdict(list)

  @contextlib.contextmanager
  def __call__(self, name: str):
    if not self.on:
      yield
      return
    with torch.profiler.record_function(SPAN_PREFIX + name):
      start = time.perf_counter()
      try:
        yield
      finally:
        self.times[name].append(time.perf_counter() - start)

  def mean(self, name: str) -> Optional[float]:
    t = self.times.get(name)
    return sum(t) / len(t) if t else None


@dataclasses.dataclass
class Trace:
  """What the profiler saw over the traced part of the window."""
  window_s: float
  kernels: List[Tuple[str, float, float]]   # (name, start us, end us)
  copies: List[Tuple[str, float, float]]    # memcpy / memset on the device
  host: List[Tuple[str, float, float]]      # the benchmark's spans
  counters: Dict[str, float]                # work done inside the trace

  def busy_s(self) -> float:
    """Seconds in which some operation ran on the device."""
    return sum(e - s for s, e in _merged(self.kernels + self.copies)) / 1e6

  def kernel_s(self, match=None) -> float:
    """Summed kernel time (seconds), of the names ``match`` accepts."""
    return sum(e - s for n, s, e in self.kernels
               if match is None or match(n)) / 1e6

  def breakdown(self, top: int = 10) -> Dict[str, list]:
    by_name: Dict[str, float] = collections.defaultdict(float)
    for n, s, e in self.kernels + self.copies:
      by_name[n[:120]] += (e - s) / 1e6
    gaps: Dict[str, float] = collections.defaultdict(float)
    busy = _merged(self.kernels + self.copies)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
      if s1 > e0:
        gaps[_host_at((e0 + s1) / 2, self.host)] += (s1 - e0) / 1e6
    order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa
    return {'device_ops': [[n, v] for n, v in order(by_name)],
            'idle_gaps': [[n, v] for n, v in order(gaps)]}


def _merged(intervals) -> List[Tuple[float, float]]:
  out: List[List[float]] = []
  for _, s, e in sorted(intervals, key=lambda x: x[1]):
    if out and s <= out[-1][1]:
      out[-1][1] = max(out[-1][1], e)
    else:
      out.append([s, e])
  return [(s, e) for s, e in out]


def _host_at(t: float, host) -> str:
  """The innermost benchmark span around host time ``t``, or 'other'."""
  best, width = 'other', float('inf')
  for n, s, e in host:
    if s <= t <= e and e - s < width:
      best, width = n, e - s
  return best


class Window:
  """The measured window of one run."""

  def __init__(self, seconds: float, trace: bool, device: torch.device,
               counters: Dict[str, float]):
    self.seconds = seconds
    self.trace_on = trace and device.type == 'cuda'
    self.device = device
    self.counters = counters
    self.trace: Optional[Trace] = None
    self._prof = None
    self._traced_from: Dict[str, float] = {}

  def sync(self) -> None:
    if self.device.type == 'cuda':
      torch.cuda.synchronize(self.device)

  def start(self) -> None:
    self.sync()
    if self.device.type == 'cuda':
      torch.cuda.reset_peak_memory_stats(self.device)
    self.t0 = time.perf_counter()

  def tick(self) -> bool:
    """Between units of work: False once the window's time is up."""
    now = time.perf_counter()
    if (self.trace_on and self._prof is None
        and self.t0 + self.seconds - now <= TRACE_SECONDS):
      self.sync()
      from torch.profiler import ProfilerActivity, profile
      self._prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
      self._prof.start()
      self._trace_t0 = time.perf_counter()
      self._traced_from = dict(self.counters)
    return now - self.t0 < self.seconds

  def close(self) -> float:
    """Waits for the device; returns the window's length in seconds."""
    self.sync()
    self.t1 = time.perf_counter()
    self.memory_peak = (torch.cuda.max_memory_allocated(self.device)
                        if self.device.type == 'cuda' else 0)
    if self._prof is not None:
      self._prof.stop()
      self.trace = _read_trace(self._prof, self.t1 - self._trace_t0, {
          k: v - self._traced_from.get(k, 0.0)
          for k, v in self.counters.items()})
      self._prof = None
    return self.t1 - self.t0


def _read_trace(prof, window_s: float, counters) -> Trace:
  kernels, copies, host = [], [], []
  cuda = torch.autograd.DeviceType.CUDA
  for e in prof.events():
    start, end = e.time_range.start, e.time_range.end
    if e.device_type == cuda:
      # A user annotation also lies on the device track, over the kernels
      # it encloses: it is not an operation.
      if getattr(e, 'is_user_annotation', False):
        continue
      low = e.name.lower()
      (copies if ('memcpy' in low or 'memset' in low) else kernels).append(
          (e.name, start, end))
    elif e.name.startswith(SPAN_PREFIX):
      host.append((e.name[len(SPAN_PREFIX):], start, end))
  return Trace(window_s, kernels, copies, host, counters)
