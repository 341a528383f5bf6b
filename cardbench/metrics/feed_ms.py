"""Mean host time to build one dispatch's batches: gathered, flattened
(``flatten_examples``) and stacked into page-locked memory
(``stack_numpy_batches``); the benchmark's span around it."""


def read(run):
  mean = run.spans.mean('feed')
  return None if mean is None else 1e3 * mean
