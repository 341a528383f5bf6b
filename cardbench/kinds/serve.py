"""Serving cells: a closed loop of one caller through the port's
``Predictor.predict``, serialized ELWC bytes in, scores on the host out.

Each request is one query's candidates: every list length of the mix's
range equally often (``pool_rounds`` requests of each), in a seeded order
that repeats until the window closes. Set-up warms each list-size bucket
of the Predictor's ladder that the mix reaches, and only those.

The latency of a request is the host clock around its ``predict`` call,
the parse included. Compared (``compare``): a sample of the requests the
window finished, drawn from the seed with the longest in it, against the
reference's scores of the same documents: the worst request's largest
score gap over its largest reference score.
"""

from __future__ import annotations

import math
import sys
import time
import traceback
from typing import Dict, List

import numpy as np
import torch

from cardbench import elwc, synth
from cardbench.reference import precision



def percentile(values: List[float], q: float) -> float:
  """Nearest-rank percentile: the smallest value with ``q``% at or below."""
  v = sorted(values)
  return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


class Cell:
  def __init__(self, ctx):
    self.ctx = ctx
    cfg, tr = ctx.config, ctx.traffic
    self.fam = ctx.family
    lengths = np.arange(tr['min_docs'], tr['max_docs'] + 1)
    docs = np.tile(lengths, tr['pool_rounds'])
    traffic = dict(tr, list_size=int(lengths.max()))
    self.examples, self.labels = self.fam.make_lists(
        cfg, traffic, ctx.seed, len(docs), docs=docs)
    self.docs = docs
    self.requests = [
        elwc.elwc([{k: v[q, d] for k, v in self.examples.items()}
                   for d in range(n)]) for q, n in enumerate(docs)]
    self.flops = [self.fam.forward_flops(
        cfg, {k: v[q:q + 1] for k, v in self.examples.items()},
        self.labels[q:q + 1]) for q in range(len(docs))]
    self.order = synth.rng(ctx.seed, 5)
    self.scores: Dict[int, np.ndarray] = {}

  def _spec(self):
    from ranking_tpu_torch.data import parsers
    t = self.ctx.traffic['seq_len']
    return {k: parsers.FixedLenFeature(shape=(t,), dtype='int64',
                                       default_value=0)
            for k in self.examples}

  def setup(self):
    from ranking_tpu_torch.data import parsers
    from ranking_tpu_torch.pipeline import serving
    ctx, cfg = self.ctx, self.ctx.config
    weights = self.fam.draw_weights(cfg, ctx.seed, ctx.device)
    model = self.fam.build(cfg, weights, ctx.device)
    del weights
    self.predictor = serving.Predictor(model, None, {}, self._spec(),
                                       device=ctx.device)
    buckets = {}
    for q, n in enumerate(self.docs):
      buckets.setdefault(parsers.bucket_list_size(int(n)), q)
    for _ in range(2):
      for q in buckets.values():
        self.predictor.predict([self.requests[q]])

  def _requests(self):
    while True:
      yield from self.order.permutation(len(self.requests)).tolist()

  def window(self, win):
    ctx = self.ctx
    c = ctx.counters
    latencies, failed = [], 0
    parse = _SpanOver(ctx.spans, 'parse') if ctx.spans.on else None
    try:
      for q in self._requests():
        if not win.tick():
          break
        n = int(self.docs[q])
        start = time.perf_counter()
        try:
          with ctx.spans('request'):
            out = self.predictor.predict([self.requests[q]])
        except Exception:  # a request that fails counts as failed
          if not failed:
            traceback.print_exc(file=sys.stderr)
          failed += 1
          continue
        latencies.append(time.perf_counter() - start)
        if out.shape[0] != 1 or out.shape[1] < n or not np.all(
            np.isfinite(out[0, :n])):
          failed += 1
          continue
        self.scores[q] = out[0, :n]
        c['requests'] += 1
        c['model_flops'] += self.flops[q]
    finally:
      if parse is not None:
        parse.close()
    win.close()
    attempted = len(latencies) + failed
    p95 = percentile(latencies, 95) * 1e3 if latencies else math.inf
    return {'serve_p95_ms': p95}, attempted, failed

  def free(self):
    self.predictor = None
    if self.ctx.device.type == 'cuda':
      torch.cuda.empty_cache()

  def sample(self, served=None) -> List[int]:
    """Served requests to check: the longest served, and others drawn from
    the seed."""
    served = sorted(self.scores if served is None else served)
    n = min(self.ctx.traffic['check_requests'], len(served))
    longest = max(served, key=lambda q: self.docs[q])
    rest = [q for q in served if q != longest]
    pick = synth.rng(self.ctx.seed, 6).permutation(len(rest))[:n - 1]
    return [longest] + [rest[i] for i in pick]

  def program_readings(self):
    return {q: self.scores[q] for q in self.sample()}

  def reference_readings(self, tf32: bool = False, requests=None):
    ctx, cfg = self.ctx, self.ctx.config
    w = self.fam.draw_weights(cfg, ctx.seed, ctx.device)
    out = {}
    with precision(tf32), torch.no_grad():
      for q in (self.sample() if requests is None else requests):
        n = int(self.docs[q])
        ex = {k: torch.from_numpy(v[q, :n]).to(ctx.device)
              for k, v in self.examples.items()}
        out[q] = self.fam.reference_scores(cfg, w, ex).double().cpu().numpy()
    return out

  def controls(self) -> Dict[str, Dict[str, float]]:
    """The compared number of the control (the reference through TF32 in
    the program's place) against the reference, over a sample of the
    requests, with no program run."""
    sample = self.sample(range(len(self.requests)))
    return {'control_tf32': self.compare(
        self.reference_readings(tf32=True, requests=sample),
        self.reference_readings(requests=sample))}

  def compare(self, prog, ref) -> Dict[str, float]:
    gap = 0.0
    for q, r in ref.items():
      p = prog.get(q)
      if p is None or p.shape != r.shape:
        return {'score_gap': math.inf}
      gap = max(gap, float(np.max(np.abs(p - r))) / max(
          float(np.max(np.abs(r))), 1e-30))
    return {'score_gap': gap}


class _SpanOver:
  """Times every call of ``parsers.parse`` as a span, the call that
  ``Predictor.predict`` makes, for as long as it is open."""

  def __init__(self, spans, name: str):
    from ranking_tpu_torch.data import parsers
    self.module, self.original = parsers, parsers.parse

    def timed(*args, **kwargs):
      with spans(name):
        return self.original(*args, **kwargs)

    parsers.parse = timed

  def close(self):
    self.module.parse = self.original
