#!/usr/bin/env python3
"""Drives the PyTorch port's serving and eval path on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases (any failure exits non-zero before the last line is printed):

1. device: requires CUDA, prints the card's name and power limit;
2. build: compiles the sort kernel from ``ranking_tpu_torch/ops/cuda/csrc``;
3. kernel vs plain: the CUDA sort against ``sorted_values_and_ranks_reference``
   on the card, required bitwise equal (ranks and sorted values), at the
   flagship shape (B=128, L=200, K=2, topn 1/5/10/200), with score ties,
   an all-invalid row and -inf scores, L=37, L at the top of the kernel's
   domain, and B=1;
4. main path: the flagship model (RankingModel(DNNScorer(1024-512-256),
   'log1p') over 136 float features, random weights and running
   statistics from a seeded ``torch.Generator``) answers
   ``Predictor.score_batch`` requests at B=1/7/128, L=200, checked against a
   float64 CPU recompute (rtol 1e-4, atol 1e-4 of the largest score; TF32
   off), then ``evaluate_dataset`` runs NDCG@1/5/10/full + MRR over flat-fed
   flagship batches; the sort kernel's launches in this phase are counted;
5. eval checks: the same evaluation with the plain sort on the card agrees
   within 1e-6, and ``make_eval_step(num_valid_rows=...)`` on a batch padded
   with ``pad_to`` equals the unpadded batch's metrics within 1e-6;
6. times after warm-up: the kernel, its plain version and ``torch.sort`` +
   ``gather`` per call, as device time (CUDA events around replays of a
   CUDA graph of 20 calls) and as eager time (CUDA events around 100
   calls, host overhead included); the eval step, its forward and a B=128
   serve request (median host clock around a synchronize);
7. with ``--profile`` only: the kernel's registers and spills from
   ``ptxas -v``, and ``torch.profiler``'s device time, operation count and
   busiest kernels of one eval step and one B=128 serve request.

Prints a ``{"timings": ...}`` line, the card line, a ``{"kernels": [...]}``
line, and last ``{"ok": true, "device": {...}}``.
"""

import json
import math
import statistics
import subprocess
import sys
import time
from unittest import mock

SEED = 0
B, L, F = 128, 200, 136           # bench.py's MSLR-WEB30K flagship shape
HIDDEN = (1024, 512, 256)
EVAL_BATCHES = 4
# HBM rate of an H100 SXM (NVIDIA data sheet), for the kernel's bound.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12             # float32 outside the tensor cores


def _fail(msg):
  raise SystemExit(f'chip_smoke: FAILED: {msg}')


def _log(msg):
  print(msg, flush=True)


def _card_line():
  out = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, timeout=60, check=True).stdout
  return out.strip().splitlines()[0]


def _event_ms(fn, iters, warmup=10):
  """Mean device time of one call, by CUDA events around ``iters`` calls."""
  import torch
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  stop = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn()
  stop.record()
  torch.cuda.synchronize()
  return start.elapsed_time(stop) / iters


def _graph_ms(fn, calls=20, replays=20):
  """Device time of one call, free of host overhead: ``calls`` calls are
  captured in one CUDA graph, whose replays are timed by CUDA events."""
  import torch
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):  # capture wants its warm-up off the default stream
    for _ in range(3):
      fn()
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    for _ in range(calls):
      fn()
  return _event_ms(graph.replay, replays, warmup=2) / calls


def _profile(fn, calls=10):
  """Device work of one call of ``fn`` under ``torch.profiler``: its device
  time (kernels and copies, which run one after another on the one stream)
  and operation count, and the device time of each kernel name."""
  import collections
  import torch
  from torch.profiler import ProfilerActivity, profile
  for _ in range(3):
    fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    for _ in range(calls):
      fn()
    torch.cuda.synchronize()
  device = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
  if not device:
    _fail('the profiler saw no device operation')
  per_name = collections.defaultdict(float)
  for e in device:  # names cut to 90 characters: C++ signatures run long
    per_name[e.name[:90]] += e.time_range.elapsed_us() / calls / 1e3
  return {'device_ms': sum(per_name.values()),
          'device_ops': len(device) / calls,
          'by_name_ms': dict(sorted(per_name.items(), key=lambda kv: -kv[1]))}


def _host_ms(fn, iters, warmup=5):
  """Median host time of one call ending in a synchronize."""
  import torch
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  times = []
  for _ in range(iters):
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
  return statistics.median(times)


def _sort_case(gen, b, l, k, kind):
  import torch
  if kind == 'ties':
    scores = torch.randint(-3, 4, (b, l), generator=gen).float()
  else:
    scores = torch.randn(b, l, generator=gen)
  mask = torch.rand(b, l, generator=gen) > 0.3
  if kind == 'special':
    mask[0] = False
    scores[1, :5] = -math.inf
    mask[1, :3] = True
  values = torch.randn(b, l, k, generator=gen)
  return scores, mask, values


def _make_batch(gen, b, *, min_len=20):
  """A flagship-shaped host batch: 136 heavy-tailed float features,
  graded 0-4 labels skewed to 0, ragged list lengths."""
  import torch
  from ranking_tpu_torch.data import batch as batch_lib
  lengths = torch.randint(min_len, L + 1, (b,), generator=gen)
  valid = torch.arange(L)[None, :] < lengths[:, None]
  grades = torch.multinomial(torch.tensor([.5, .3, .15, .04, .01]), b * L,
                             replacement=True, generator=gen).reshape(b, L)
  labels = torch.where(valid, grades.float(), -1.0)
  features = torch.exp(2.0 * torch.randn(b, L, F, generator=gen))
  features *= torch.where(torch.rand(b, L, F, generator=gen) < 0.1, -1.0, 1.0)
  return batch_lib.RankingBatch(context={}, examples={'features': features},
                                labels=labels, mask=valid)


def _flagship_model(gen):
  import torch
  from ranking_tpu_torch.models import scorers
  model = scorers.RankingModel(
      scorers.DNNScorer(HIDDEN, in_features=F, generator=gen),
      transform_name='log1p')
  with torch.no_grad():  # non-trivial BN parameters and running statistics
    for bn in model.scorer.tower.bn:
      n = bn.num_features
      bn.weight.copy_(1.0 + 0.1 * torch.randn(n, generator=gen))
      bn.bias.copy_(0.1 * torch.randn(n, generator=gen))
      bn.running_mean.copy_(0.5 * torch.randn(n, generator=gen))
      bn.running_var.copy_(torch.rand(n, generator=gen) * 1.5 + 0.5)
  return model


def _scores_f64(model, batch):
  """Float64 CPU recompute of the flagship model's eval forward."""
  import torch
  import torch.nn.functional as nnf
  from ranking_tpu_torch.models import layers
  tower = model.scorer.tower
  d = lambda t: t.detach().to('cpu', torch.float64)  # noqa: E731
  x = d(batch.examples['features'])
  h = (torch.sign(x) * torch.log1p(torch.abs(x))).reshape(-1, F)
  for layer, bn in zip(tower.dense[:-1], tower.bn):
    h = nnf.linear(h, d(layer.weight), d(layer.bias))
    h = ((h - d(bn.running_mean)) / torch.sqrt(d(bn.running_var) + bn.eps)
         * d(bn.weight) + d(bn.bias))
    h = torch.relu(h)
  h = nnf.linear(h, d(tower.dense[-1].weight), d(tower.dense[-1].bias))
  return torch.where(batch.mask, h.reshape(batch.mask.shape),
                     layers.PADDING_LOGIT)


def _metric_fns():
  from ranking_tpu_torch.ops import metric_registry
  fns = dict(metric_registry.default_metric_fns())
  fns['metric/mrr'] = metric_registry.make_ranking_metric_fn(
      metric_registry.RankingMetricKey.MRR)
  return fns


def main():
  import torch
  if not torch.cuda.is_available():
    print('chip_smoke: CUDA is not available; this script runs on the card',
          file=sys.stderr)
    return 1
  from ranking_tpu_torch.data import dataset
  from ranking_tpu_torch.models import layers
  from ranking_tpu_torch.ops.cuda import build
  from ranking_tpu_torch.ops.cuda import sort as cuda_sort
  from ranking_tpu_torch.pipeline import serving
  from ranking_tpu_torch.train import steps
  from ranking_tpu_torch.utils import list_ops

  # Phase 1: device. Full float32 matmuls: the serve check is at 1e-4.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device('cuda')
  card = _card_line()
  kind = torch.cuda.get_device_name(0)
  _log(f'device: {kind} ({torch.cuda.device_count()} visible), torch '
       f'{torch.__version__}, CUDA {torch.version.cuda}')

  # Phase 2: build.
  t0 = time.perf_counter()
  cuda_sort._kernel()
  _log(f'build: sort kernel in {time.perf_counter() - t0:.2f} s '
       f'({build.library_path("sort")})')

  # Phase 3: kernel vs plain on the card, bitwise.
  gen = torch.Generator().manual_seed(SEED)
  cases = [(f'flagship_top{n}', B, L, 2, n, 'random') for n in (1, 5, 10, L)]
  cases += [('ties', B, L, 2, L, 'ties'),
            ('all_invalid_and_neg_inf', 4, L, 2, L, 'special'),
            ('list_size_37', 3, 37, 3, 10, 'random'),
            ('top_of_domain', 2, cuda_sort.MAX_LIST_SIZE, 2, 100, 'ties'),
            ('batch_1', 1, L, 2, L, 'random')]
  max_abs_err = 0.0
  for name, b, l, k, topn, data in cases:
    scores, mask, values = (t.to(dev) for t in _sort_case(gen, b, l, k, data))
    got_sorted, got_ranks = cuda_sort.sorted_values_and_ranks(
        scores, values, mask, topn)
    want_sorted, want_ranks = cuda_sort.sorted_values_and_ranks_reference(
        scores, values, mask, topn)
    torch.cuda.synchronize()
    for got, want in ((got_sorted, want_sorted), (got_ranks, want_ranks)):
      if got.shape != want.shape:
        _fail(f'sort case {name}: shape {tuple(got.shape)} != '
              f'{tuple(want.shape)}')
      err = (got - want).abs().nan_to_num(nan=math.inf).max().item()
      max_abs_err = max(max_abs_err, err)
      if not torch.equal(got, want):
        _fail(f'sort case {name}: kernel != plain version (max |diff| '
              f'{err})')
    _log(f'kernel vs plain: {name} (B={b}, L={l}, K={k}, topn={topn}) equal')

  # Phase 4: the main path. Counts start at 0 here.
  model = _flagship_model(gen)
  requests = [_make_batch(gen, b, min_len=1) for b in (1, 7, B)]
  eval_batches = [dataset.flatten_examples(_make_batch(gen, B))
                  for _ in range(EVAL_BATCHES)]
  fns = _metric_fns()
  cuda_sort.sorted_values_and_ranks.launches = 0
  predictor = serving.Predictor(model, device='cuda')
  served = [predictor.score_batch(r) for r in requests]
  results = serving.evaluate_dataset(predictor.model, None, eval_batches,
                                     metric_fns=fns, device='cuda')
  launches = cuda_sort.sorted_values_and_ranks.launches
  if launches == 0:
    _fail('the eval path never launched the sort kernel')
  _log(f'main path: served {[r.batch_size for r in requests]} lists, '
       f'evaluated {EVAL_BATCHES} x {B} lists; sort kernel launches '
       f'{launches} ({launches / EVAL_BATCHES:g} per eval step)')

  for req, got in zip(requests, served):
    got = torch.from_numpy(got)
    if got.shape != req.mask.shape or not torch.isfinite(got).all():
      _fail(f'serve B={req.batch_size}: bad scores shape/finiteness')
    if not torch.all(got[~req.mask] == torch.tensor(layers.PADDING_LOGIT)):
      _fail(f'serve B={req.batch_size}: padded slots != log(1e-10)')
    want = _scores_f64(model, req)
    scale = want[req.mask].abs().max().item()
    err = (got.double() - want)[req.mask].abs().max().item()
    if not torch.allclose(got.double(), want, rtol=1e-4, atol=1e-4 * scale):
      _fail(f'serve B={req.batch_size}: max |diff| {err} vs float64 '
            f'(largest score {scale})')
    _log(f'serve B={req.batch_size}: max |diff| vs float64 {err:.3g} '
         f'(largest score {scale:.3g})')

  # Phase 5: eval checks.
  for name, value in results.items():
    if not 0.0 <= value <= 1.0:
      _fail(f'eval {name} = {value} outside [0, 1]')
  with mock.patch.object(list_ops, '_kernel_sort_ok', return_value=False):
    before = cuda_sort.sorted_values_and_ranks.launches
    plain = serving.evaluate_dataset(predictor.model, None, eval_batches,
                                     metric_fns=fns, device='cuda')
    if cuda_sort.sorted_values_and_ranks.launches != before:
      _fail('the plain-sort evaluation launched the kernel')
  for name in results:
    if abs(results[name] - plain[name]) > 1e-6:
      _fail(f'eval {name}: kernel {results[name]} vs plain sort '
            f'{plain[name]}')
  _log('eval: ' + ', '.join(f'{k} {v:.6f}' for k, v in results.items())
       + ' (plain sort on the card agrees within 1e-6)')

  step = steps.make_eval_step(fns, device='cuda')
  tail = _make_batch(gen, 100)
  padded_states, _ = step(predictor.model,
                          dataset.flatten_examples(tail.pad_to(B)),
                          steps.init_metric_states(fns), num_valid_rows=100)
  tail_states, _ = step(predictor.model, tail, steps.init_metric_states(fns))
  for name in fns:
    a = padded_states[name].result().item()
    e = tail_states[name].result().item()
    if abs(a - e) > 1e-6:
      _fail(f'padded eval {name}: {a} vs unpadded {e}')
  _log('eval: 100 lists padded to 128 with num_valid_rows=100 == unpadded')

  # Phase 6: times at the flagship shape.
  scores, mask, values = (t.to(dev) for t in _sort_case(gen, B, L, 2,
                                                        'random'))
  idx_shape = (B, L, 2)

  def library_call():
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    return torch.gather(values, 1, order[:, :, None].expand(idx_shape))

  sort_calls = {
      'kernel': lambda: cuda_sort.sorted_values_and_ranks(scores, values,
                                                          mask, L),
      'plain': lambda: cuda_sort.sorted_values_and_ranks_reference(
          scores, values, mask, L),
      'library': library_call}
  # Device time from graph replays; eager time per call as the main path
  # pays it, host overhead included.
  sort_ms = {k: _graph_ms(fn) for k, fn in sort_calls.items()}
  sort_eager_ms = {k: _event_ms(fn, 100) for k, fn in sort_calls.items()}
  kernel_ms, plain_ms, library_ms = (sort_ms[k] for k in
                                     ('kernel', 'plain', 'library'))
  # Bound: each input read once, each output written once, over HBM; the
  # B*L*L pair comparisons over the float32 rate. Bytes win at this shape.
  sort_bytes = B * L * (4 + 1 + 2 * 4) + B * L * 4 + B * L * 2 * 4
  bytes_ms = sort_bytes / HBM_BYTES_PER_S * 1e3
  ops_ms = B * L * L / F32_OPS_PER_S * 1e3
  bound_ms, bound_by = max((bytes_ms, 'bytes'), (ops_ms, 'operations'))

  dev_batch = eval_batches[0].to(dev)
  states = steps.init_metric_states(fns)
  eval_step_ms = _host_ms(lambda: step(predictor.model, dev_batch, states),
                          50)
  restored = steps.restore_flat_examples(dev_batch)
  with torch.no_grad():
    forward_ms = _host_ms(lambda: predictor.model(
        restored.context, restored.examples, restored.mask), 50)
  serve_ms = _host_ms(lambda: predictor.score_batch(requests[-1]), 30)
  timings = {
      'sort_kernel_ms': kernel_ms, 'sort_plain_ms': plain_ms,
      'sort_library_ms': library_ms, 'sort_bound_ms': bound_ms,
      'sort_eager_ms': sort_eager_ms,
      'sort_launches_per_eval_step': launches / EVAL_BATCHES,
      'eval_step_ms': eval_step_ms,
      'eval_lists_per_s': B / eval_step_ms * 1e3,
      'eval_forward_ms': forward_ms, 'serve_b128_ms': serve_ms,
      'card': card}
  _log(json.dumps({'timings': timings}))

  if '--profile' in sys.argv[1:]:
    # Phase 7 (optional): the kernel's resources and where the device
    # time of an eval step and a serve request goes.
    log = build.compile_library('sort', ('-Xptxas', '-v')) + '.log'
    with open(log) as f:
      _log('ptxas: ' + ' | '.join(line.strip() for line in f
                                  if 'registers' in line or 'spill' in line))
    for name, fn, host_ms in (
        ('eval_step', lambda: step(predictor.model, dev_batch, states),
         eval_step_ms),
        ('serve_b128', lambda: predictor.score_batch(requests[-1]),
         serve_ms)):
      prof = _profile(fn)
      prof['host_ms'] = host_ms
      prof['device_idle_share'] = 1.0 - prof['device_ms'] / host_ms
      prof['by_name_ms'] = dict(list(prof['by_name_ms'].items())[:12])
      _log(json.dumps({'profile': name, **prof}))

  kernels = [{
      'name': 'sorted_values_and_ranks', 'route': 'cuda',
      'source': 'ranking_tpu_torch/ops/cuda/csrc/sort.cu',
      'replaces': 'ranking_tpu/ops/pallas/sort.py:115',
      'launches': launches, 'max_abs_err': max_abs_err, 'check': 'bitwise',
      'ms': kernel_ms, 'eager_ms': sort_eager_ms['kernel'], 'plain_ms': plain_ms, 'bound_ms': bound_ms,
      'bound_by': bound_by, 'library_ms': library_ms}]
  print(card)
  print(json.dumps({'kernels': kernels}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
