"""Mean host time of ``parsers.parse`` in a request, called as
``Predictor.predict`` calls it; the benchmark's span around that call."""


def read(run):
  mean = run.spans.mean('parse')
  return None if mean is None else 1e3 * mean
