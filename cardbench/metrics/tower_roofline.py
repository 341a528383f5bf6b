"""The batch-normalized tower's share of its roofline: the least time the
card needs for the tower's training function over the traced steps' valid
documents (``work.tower_train_work``: operations at the TF32 peak, bytes
at the HBM rate) over the device time of the kernels that compute it
today (kernel rows 2-4: ``csrc/fused_bn_fwd.cu``, ``fused_bn_bwd.cu``,
``fused_bn_common.cuh``). Where none of them ran, nothing is read."""

from cardbench import work
from cardbench.families import dnn

KERNELS = ('layer_forward_kernel', 'bwd_stats_kernel', 'bwd_dx_kernel',
           'over_rows_kernel', 'reduce_partials_kernel', 'split_weight_kernel')


def read(run):
  trace = run.trace
  if trace is None:
    return None
  seconds = trace.kernel_s(lambda n: any(k in n for k in KERNELS))
  steps = trace.counters.get('steps', 0.0)
  docs = trace.counters.get('valid_docs', 0.0)
  if seconds <= 0 or not steps:
    return None
  bound = steps * work.bound_seconds(
      *work.tower_train_work(docs / steps, dnn.dims(run.config)))
  return 100.0 * bound / seconds
