#!/usr/bin/env python3
"""Drives the PyTorch port's serving, eval and training paths on one CUDA
card.

    python3 chip_smoke.py [--profile]

Phases (any failure exits non-zero before the last line is printed):

1. device: requires CUDA, prints the card's name and power limit;
2. build: compiles the three kernel sources of
   ``ranking_tpu_torch/ops/cuda/csrc`` side by side (the sort, the fused
   masked-BN tower's forward and its backward);
3. kernel vs plain: the CUDA sort against ``sorted_values_and_ranks_reference``
   on the card, required bitwise equal (ranks and sorted values), at the
   flagship shape (B=128, L=200, K=2, topn 1/5/10/200), with score ties,
   an all-invalid row and -inf scores, L=37, L at the top of the kernel's
   domain, and B=1. Then the five fused masked-BN functions
   (``ops/cuda/fused_bn.py``) against their plain versions at the flagship
   widths 136-1024-512-256, in float32 and bfloat16, at N=25600 and N=700
   with a ragged mask and at N=700 with an all-ones and an all-zero mask
   (tolerances at ``FUSED_TOL``: these are sums over up to 25600 rows in
   another order, so bitwise equality is not expected), and the whole
   ``fused_bn_mlp`` (outputs, means, vars, all gradients) against autograd
   through ``reference_bn_mlp`` on the card and in float64 on the CPU;
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
7. training main path: the flagship model in train mode (dropout 0,
   ``input_grad=False``, batch norm, float32, 'log1p'), ``softmax_loss``, Adam
   1e-3, 8 steps of ``make_train_step`` on a repeated flat-fed batch. The
   first step's loss, gradients and running statistics are held against
   the same step with the plain versions forced on the card; the loss must
   be finite at every step and lower after 8; the launches per step must be
   3 / 1 / 2 / 0 / 0 for the five functions; the trained model is then
   evaluated through the eval path;
8. second path: a one-hidden-layer tower (136 -> 1024) whose input needs a
   gradient, one forward and backward at N=25600: ``dx0`` and ``dW0``
   against the plain versions, one launch each of the two first-layer
   functions;
9. times of the fused functions (device time from CUDA graph replays, each
   beside its plain version and its bound) and of a train step (host clock
   and CUDA events), beside the same step with the fused switch off;
10. with ``--profile`` only: the kernels' registers and spills from
   ``ptxas -v``, and ``torch.profiler``'s device time, operation count and
   busiest kernels of one eval step, one B=128 serve request and one train
   step.

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
N_ROWS = B * L                    # 25600 documents in a flagship batch
TRAIN_STEPS = 8
# Largest |kernel - plain| allowed, as a share of the largest |plain| value
# of the same output. float32: both sides sum the same float32 products in
# another order (up to 25600 rows, 1024 terms). bfloat16: outputs stored as
# bf16 may differ by one bf16 ulp of the largest value (2^-8, rounded up to
# 2^-7); float32 sums of bf16-rounded operands see an operand rounded the
# other way now and then.
FUSED_TOL = {'float32': {'stored': 1e-5, 'summed': 1e-5},
             'bfloat16': {'stored': 2.0 ** -7, 'summed': 2e-3}}
# The whole op against autograd through another formulation of the same
# function: a handful of ReLU gates whose pre-activation is within rounding
# of 0 open on one side only, and each moves a gradient entry by one row's
# whole contribution. So the error is held in the Frobenius norm, and the
# largest single entry only loosely.
OP_TOL_NORM, OP_TOL_MAX = 2e-3, 5e-2


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


def _rel_err(got, want):
  """(largest |got - want|, that as a share of the largest |want|)."""
  import torch
  got, want = got.to(torch.float32), want.to(torch.float32)
  if got.shape != want.shape:
    _fail(f'shape {tuple(got.shape)} != {tuple(want.shape)}')
  err = (got - want).abs().nan_to_num(nan=math.inf).max().item()
  return err, err / max(want.abs().max().item(), 1e-30)


def _fused_case(gen, n, mask_kind, act, dims=(F,) + HIDDEN):
  """Inputs of every fused function at one tower shape: a seeded tower and
  batch, the hidden activations and folds of a forward chain (through the
  plain versions) and random cotangents of the right scale."""
  import torch
  from ranking_tpu_torch.ops.cuda import fused_bn
  dev = torch.device('cuda')
  rnd = lambda *shape, scale=1.0: (  # noqa: E731
      torch.randn(*shape, generator=gen) * scale).to(dev)
  x = rnd(n, dims[0])
  mask = {'ragged': (torch.rand(n, generator=gen) > 0.3).float(),
          'ones': torch.ones(n), 'zeros': torch.zeros(n)}[mask_kind].to(dev)
  count = mask.sum().clamp(min=1.0)
  layers = []
  h, relu_in = x, False
  s_in = torch.ones(dims[0], device=dev)
  t_in = torch.zeros(dims[0], device=dev)
  with fused_bn.plain_versions():
    for f_in, f_out in zip(dims[:-1], dims[1:]):
      w = rnd(f_out, f_in, scale=f_in ** -0.5)
      b, gamma, beta = rnd(f_out, scale=.1), 1 + rnd(f_out, scale=.1), \
          rnd(f_out, scale=.1)
      y, col_sum, col_ssq = fused_bn.layer_forward(
          h, mask, s_in, t_in, w.t(), b, relu_in=relu_in, act_dtype=act)
      fold = fused_bn._bn_fold(col_sum, col_ssq, gamma, beta, count, 1e-5)
      g = rnd(n, f_out).to(act)
      s1, s2 = fused_bn.bwd_stats(g, y, fold[3], fold[4])
      _, _, c1, c2, _ = fused_bn._layer_consts(fold, s1, s2, col_sum, count)
      layers.append(dict(x_in=h, s_in=s_in, t_in=t_in, relu_in=relu_in, w=w,
                         b=b, y=y, s=fold[3], t=fold[4], g=g, c1=c1, c2=c2))
      h, s_in, t_in, relu_in = y, fold[3], fold[4], True
  return dict(x=x, mask=mask, layers=layers, act=act)


def _fused_calls(case):
  """{row name: [(shape label, fn)]}: every call a train step makes of rows
  2-4 at this case's shapes, and the calls of rows 5 and 6 at layer 0's."""
  from ranking_tpu_torch.ops.cuda import fused_bn
  x, mask, act = case['x'], case['mask'], case['act']
  ls = case['layers']
  top = len(ls) - 1

  def label(l):
    return f"{ls[l]['w'].shape[1]}->{ls[l]['w'].shape[0]}"

  def fwd(l):
    a = ls[l]
    return lambda: fused_bn.layer_forward(
        a['x_in'], mask, a['s_in'], a['t_in'], a['w'].t(), a['b'],
        relu_in=a['relu_in'], act_dtype=act)

  def mats(l, fold):
    a = ls[l]
    return lambda: fused_bn.bwd_mats(
        a['g'], a['y'], mask, a['s'], a['t'], a['c1'], a['c2'], a['x_in'],
        a['s_in'], a['t_in'], a['w'].t(), relu_in=True, emit_prev_stats=True,
        x0=x if fold else None, emit_dx=not fold)

  a0, at = ls[0], ls[top]
  return {
      'layer_forward': [(label(l), fwd(l)) for l in range(len(ls))],
      'bwd_stats': [(str(at['y'].shape[1]), lambda: fused_bn.bwd_stats(
          at['g'], at['y'], at['s'], at['t']))],
      'bwd_mats': [(label(l) + (' +fold' if l == 1 else ''), mats(l, l == 1))
                   for l in range(top, 0, -1)],
      'bwd_dx_only': [(label(0), lambda: fused_bn.bwd_dx_only(
          a0['g'], a0['y'], mask, a0['s'], a0['t'], a0['c1'], a0['c2'],
          a0['w'].t()))],
      'bwd_dw_only': [(label(0), lambda: fused_bn.bwd_dw_only(
          a0['g'], a0['y'], mask, a0['s'], a0['t'], a0['c1'], a0['c2'],
          a0['x_in'], a0['s_in'], a0['t_in'], relu_in=False))],
  }


def _fused_bounds(n=N_ROWS, dims=(F,) + HIDDEN):
  """{row name: [(bound_ms, bound_by)]} for the float32 calls of
  ``_fused_calls``: each input read once and each output written once over
  the HBM rate, against the products' operations over the float32 rate."""
  size = 4  # bytes of a stored activation

  def bound(byte_count, op_count):
    return max((byte_count / HBM_BYTES_PER_S * 1e3, 'bytes'),
               (op_count / F32_OPS_PER_S * 1e3, 'operations'))

  f0 = dims[0]
  out = {'layer_forward': [], 'bwd_mats': []}
  for f_in, f_out in zip(dims[:-1], dims[1:]):
    out['layer_forward'].append(bound(
        n * f_in * size + n * 4 + 4 * (2 * f_in + f_in * f_out + f_out)
        + n * f_out * size + 8 * f_out, 2 * n * f_in * f_out))
  top = len(dims) - 2
  f_top = dims[-1]
  out['bwd_stats'] = [bound(2 * n * f_top * size + 16 * f_top,
                            4 * n * f_top)]
  for l in range(top, 0, -1):
    f_in, f_out = dims[l], dims[l + 1]
    fold = l == 1
    byte_count = (2 * n * f_out * size + n * 4 + 16 * f_out
                  + n * f_in * size + 8 * f_in + 4 * f_in * f_out  # inputs
                  + 4 * f_in * f_out + 8 * f_in)                   # dW, s1, s2
    op_count = 4 * n * f_in * f_out
    if fold:
      byte_count += n * f0 * 4 + 2 * 4 * f0 * f_in   # x0 in; A, B out
      op_count += 4 * n * f0 * f_in
    else:
      byte_count += n * f_in * size                  # dx out
    out['bwd_mats'].append(bound(byte_count, op_count))
  f1 = dims[1]
  out['bwd_dx_only'] = [bound(2 * n * f1 * size + n * 4 + 16 * f1
                              + 4 * f0 * f1 + n * f0 * 4, 2 * n * f0 * f1)]
  out['bwd_dw_only'] = [bound(2 * n * f1 * size + n * 4 + 16 * f1
                              + n * f0 * 4 + 8 * f0 + 4 * f0 * f1,
                              2 * n * f0 * f1)]
  return out


def _check_fused_kernels(gen):
  """Phase 3b: each fused function against its plain version. Returns
  {row name: {'float32': (max abs, max rel), 'bfloat16': ...}}."""
  import torch
  from ranking_tpu_torch.ops.cuda import fused_bn
  # Which outputs are stored in the activation type (the rest are float32
  # sums).
  stored = {'layer_forward': (0,), 'bwd_stats': (), 'bwd_mats': (0,),
            'bwd_dx_only': (), 'bwd_dw_only': ()}
  worst = {}
  for act in (torch.float32, torch.bfloat16):
    name = str(act).split('.')[-1]
    for n, mask_kind in ((N_ROWS, 'ragged'), (700, 'ragged'), (700, 'ones'),
                         (700, 'zeros')):
      case = _fused_case(gen, n, mask_kind, act)
      for row, calls in _fused_calls(case).items():
        for shape, fn in calls:
          got = fn()
          with fused_bn.plain_versions():
            want = fn()
          torch.cuda.synchronize()
          got, want = ((o,) if isinstance(o, torch.Tensor) else o
                       for o in (got, want))
          for i, (g, w) in enumerate(zip(got, want)):
            if (g is None) != (w is None):
              _fail(f'{row} {shape}: output {i} missing on one side')
            if g is None:
              continue
            err, rel = _rel_err(g, w)
            tol = FUSED_TOL[name]['stored' if i in stored[row] else 'summed']
            if not rel <= tol:
              _fail(f'{row} {shape} {name} N={n} mask={mask_kind}: output '
                    f'{i} differs from the plain version by {err} '
                    f'({rel:.3g} of its largest value; allowed {tol:.3g})')
            old = worst.setdefault(row, {}).get(name, (0.0, 0.0))
            worst[row][name] = (max(old[0], err), max(old[1], rel))
      _log(f'kernel vs plain: fused BN rows 2-6, {name}, N={n}, '
           f'{mask_kind} mask: within tolerance')
  return worst


def _check_fused_op(gen):
  """Phase 3c: fused_bn_mlp at the flagship shape against autograd through
  reference_bn_mlp, on the card in float32 and on the CPU in float64."""
  import torch
  from ranking_tpu_torch.ops.cuda import fused_bn
  dev = torch.device('cuda')
  dims = (F,) + HIDDEN
  x = torch.randn(N_ROWS, F, generator=gen)
  mask = (torch.rand(N_ROWS, generator=gen) > 0.3).float()
  cot = torch.randn(N_ROWS, HIDDEN[-1], generator=gen)
  params = [[torch.randn(o, i, generator=gen) * i ** -0.5
             for i, o in zip(dims[:-1], dims[1:])],
            [0.1 * torch.randn(o, generator=gen) for o in HIDDEN],
            [1 + 0.1 * torch.randn(o, generator=gen) for o in HIDDEN],
            [0.1 * torch.randn(o, generator=gen) for o in HIDDEN]]

  def run(fn, device, dtype):
    leaves = [[p.to(device, dtype).requires_grad_() for p in group]
              for group in params]
    xd = x.to(device, dtype).requires_grad_()
    out, means, vars_ = fn(xd, mask.to(device), *leaves)
    flat = [xd] + [p for group in leaves for p in group]
    grads = torch.autograd.grad((out * cot.to(device, dtype)).sum(), flat)
    return [t.detach().to('cpu', torch.float64)
            for t in (out, *means, *vars_, *grads)]

  got = run(lambda *a: fused_bn.fused_bn_mlp(*a, input_grad=True), dev,
            torch.float32)
  refs = {
      'autograd on the card': run(
          lambda xd, m, *p: fused_bn.reference_bn_mlp(xd, *p, mask=m), dev,
          torch.float32),
      'float64 on the CPU': run(
          lambda xd, m, *p: fused_bn.reference_bn_mlp(xd, *p, mask=m), 'cpu',
          torch.float64)}
  n_fwd = 1 + 2 * len(HIDDEN)
  for name, want in refs.items():
    worst_fwd = worst_norm = worst_max = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
      scale = max(w.abs().max().item(), 1e-30)
      err = (g - w).abs().max().item() / scale
      if i < n_fwd:
        worst_fwd = max(worst_fwd, err)
        continue
      if scale < 1e-2:  # bias gradients: exactly 0 in theory, noise here
        if (g - w).abs().max().item() > 1e-2:
          _fail(f'fused op vs {name}: a zero gradient is off by more than '
                '1e-2')
        continue
      worst_norm = max(worst_norm, ((g - w).norm() / w.norm()).item())
      worst_max = max(worst_max, err)
    if not (worst_fwd <= 1e-4 and worst_norm <= OP_TOL_NORM
            and worst_max <= OP_TOL_MAX):
      _fail(f'fused op vs {name}: outputs off by {worst_fwd:.3g} (allowed '
            f'1e-4), gradients by {worst_norm:.3g} in norm (allowed '
            f'{OP_TOL_NORM}) and {worst_max:.3g} at most (allowed '
            f'{OP_TOL_MAX})')
    _log(f'fused op vs {name}: outputs within {worst_fwd:.3g}, gradients '
         f'within {worst_norm:.3g} in norm, {worst_max:.3g} at most')


def _train_model(gen, hidden=HIDDEN):
  from ranking_tpu_torch.models import scorers
  return scorers.RankingModel(
      scorers.DNNScorer(hidden, in_features=F, dropout=0.0, input_grad=False,
                        generator=gen), transform_name='log1p')


def _launch_counts():
  from ranking_tpu_torch.ops.cuda import fused_bn
  return [fn.launches for fn in fused_bn.KERNEL_WRAPPERS]


def _train_main_path(gen, eval_batches, fns):
  """Phase 7. Returns (launch counts of the run, trained state, step fn,
  batch)."""
  import copy
  import torch
  from ranking_tpu_torch.data import dataset
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.ops.cuda import fused_bn
  from ranking_tpu_torch.pipeline import serving
  from ranking_tpu_torch.train import state as state_lib
  from ranking_tpu_torch.train import steps
  model = _train_model(gen)
  twin = copy.deepcopy(model)
  batch = dataset.flatten_examples(_make_batch(gen, B))
  loss_fn = loss_registry.make_loss_fn('softmax_loss')
  step = steps.make_train_step(loss_fn, device='cuda')

  # The main path: counts start at 0 here.
  fused_bn.reset_launches()
  state = state_lib.create_train_state(model, state_lib.adam(1e-3),
                                       device='cuda')
  losses = []
  first_grads = None
  for i in range(TRAIN_STEPS):
    state, metrics = step(state, batch)
    losses.append(metrics['loss'].item())
    if i == 0:
      first_grads = {k: p.grad.clone()
                     for k, p in state.model.named_parameters()}
      first_stats = {k: v.clone() for k, v in state.model.state_dict().items()
                     if 'running' in k}
  trained_eval = serving.evaluate_dataset(state.model, None, eval_batches,
                                          metric_fns=fns, device='cuda')
  counts = _launch_counts()
  torch.cuda.synchronize()

  if not all(math.isfinite(v) for v in losses):
    _fail(f'train: a loss is not finite: {losses}')
  if not losses[-1] < losses[0]:
    _fail(f'train: the loss did not fall in {TRAIN_STEPS} steps on a '
          f'repeated batch: {losses}')
  per_step = [c / TRAIN_STEPS for c in counts]
  if per_step != [3, 1, 2, 0, 0]:
    _fail(f'train: launches per step {per_step} != [3, 1, 2, 0, 0] for '
          f'rows 2-6')
  for name, value in trained_eval.items():
    if not 0.0 <= value <= 1.0:
      _fail(f'eval of the trained model: {name} = {value} outside [0, 1]')
  _log(f'train: {TRAIN_STEPS} steps at B={B}, L={L}, F={F}, loss '
       f'{losses[0]:.6f} -> {losses[-1]:.6f}; launches per step {per_step}; '
       'trained model eval: '
       + ', '.join(f'{k} {v:.4f}' for k, v in trained_eval.items()))

  # The same first step through the plain versions, on the card.
  twin_state = state_lib.create_train_state(twin, state_lib.adam(1e-3),
                                            device='cuda')
  before = _launch_counts()
  with fused_bn.plain_versions():
    twin_state, twin_metrics = step(twin_state, batch)
  if _launch_counts() != before:
    _fail('the plain-version step launched a kernel')
  loss_err = abs(twin_metrics['loss'].item() - losses[0])
  if loss_err > 1e-5 * abs(losses[0]):
    _fail(f'train: first loss {losses[0]} vs plain versions '
          f'{twin_metrics["loss"].item()}')
  worst_norm = worst_max = 0.0
  for k, p in twin_state.model.named_parameters():
    g, w = first_grads[k], p.grad
    scale = w.abs().max().item()
    if scale < 1e-6:   # zero in theory (biases in front of a batch norm)
      if (g - w).abs().max().item() > 1e-6:
        _fail(f'train: zero gradient {k} off by more than 1e-6')
      continue
    worst_norm = max(worst_norm, ((g - w).norm() / w.norm()).item())
    worst_max = max(worst_max, (g - w).abs().max().item() / scale)
  if worst_norm > OP_TOL_NORM or worst_max > OP_TOL_MAX:
    _fail(f'train: first-step gradients differ from the plain versions by '
          f'{worst_norm:.3g} in norm, {worst_max:.3g} at most')
  stat_err = 0.0
  for k, v in twin_state.model.state_dict().items():
    if 'running' in k:
      stat_err = max(stat_err, _rel_err(first_stats[k], v)[1])
  if stat_err > 1e-5:
    _fail(f'train: running statistics differ from the plain versions by '
          f'{stat_err:.3g}')
  _log(f'train: first step vs plain versions on the card: loss within '
       f'{loss_err:.3g}, gradients within {worst_norm:.3g} in norm and '
       f'{worst_max:.3g} at most, running statistics within {stat_err:.3g}')
  return counts, state, step, batch


def _second_path(gen):
  """Phase 8: rows 5 and 6 through the Function. Returns their launches
  and largest errors."""
  import torch
  from ranking_tpu_torch.ops.cuda import fused_bn
  dev = torch.device('cuda')
  f1 = HIDDEN[0]
  x = torch.randn(N_ROWS, F, generator=gen).to(dev)
  mask = (torch.rand(N_ROWS, generator=gen) > 0.3).to(dev)
  cot = torch.randn(N_ROWS, f1, generator=gen).to(dev)
  params = [(torch.randn(f1, F, generator=gen) * F ** -0.5).to(dev),
            (0.1 * torch.randn(f1, generator=gen)).to(dev),
            (1 + 0.1 * torch.randn(f1, generator=gen)).to(dev),
            (0.1 * torch.randn(f1, generator=gen)).to(dev)]

  def run():
    xd = x.clone().requires_grad_()
    leaves = [p.clone().requires_grad_() for p in params]
    out, _, _ = fused_bn.fused_bn_mlp(xd, mask, *([p] for p in leaves),
                                      input_grad=True)
    return torch.autograd.grad((out * cot).sum(), [xd, leaves[0]])

  fused_bn.reset_launches()
  dx0, dw0 = run()
  counts = _launch_counts()
  with fused_bn.plain_versions():
    want_dx0, want_dw0 = run()
  torch.cuda.synchronize()
  if counts != [1, 1, 0, 1, 1]:
    _fail(f'second path: launches {counts} != [1, 1, 0, 1, 1] for rows 2-6')
  errs = {'bwd_dx_only': _rel_err(dx0, want_dx0),
          'bwd_dw_only': _rel_err(dw0, want_dw0)}
  for name, (err, rel) in errs.items():
    # The forward's y differs in its last bits between the two runs, so a
    # gate may flip: the whole-op tolerance applies, not the kernel's.
    if rel > OP_TOL_MAX:
      _fail(f'second path: {name} off by {err} ({rel:.3g} of its largest)')
  _log(f'second path: one-layer tower {F}->{f1} with an input gradient: '
       + ', '.join(f'{k} within {v[1]:.3g}' for k, v in errs.items())
       + f'; launches {counts}')
  return {'bwd_dx_only': counts[3], 'bwd_dw_only': counts[4]}


def _time_fused(gen):
  """Phase 9a: {row name: {'ms', 'plain_ms', 'ms_by_shape', ...}} at the
  flagship shapes, float32; device time per call from CUDA graph replays."""
  import torch
  from ranking_tpu_torch.ops.cuda import fused_bn
  case = _fused_case(gen, N_ROWS, 'ragged', torch.float32)
  bounds = _fused_bounds()
  out = {}
  for row, calls in _fused_calls(case).items():
    by_shape, plain_by_shape = {}, {}
    for shape, fn in calls:
      by_shape[shape] = _graph_ms(fn, calls=5, replays=10)
      with fused_bn.plain_versions():
        plain_by_shape[shape] = _graph_ms(fn, calls=5, replays=10)
    out[row] = {'ms': sum(by_shape.values()),
                'plain_ms': sum(plain_by_shape.values()),
                'bound_ms': sum(b for b, _ in bounds[row]),
                'bound_by': max(bounds[row])[1],  # of the largest call
                'ms_by_shape': by_shape, 'plain_ms_by_shape': plain_by_shape,
                'bound_ms_by_shape': dict(zip(by_shape,
                                              (b for b, _ in bounds[row])))}
  return out


def _time_train_step(state, step, batch):
  """Phase 9b: a train step's host and device time, fused and unfused."""
  import torch
  from ranking_tpu_torch.ops.cuda import fused_bn
  dev_batch = batch.to(torch.device('cuda'))
  fn = lambda: step(state, dev_batch)  # noqa: E731
  out = {}
  for name, switch in (('fused', None), ('unfused', False)):
    fused_bn.set_enabled(switch)
    try:
      out[f'train_step_{name}_host_ms'] = _host_ms(fn, 20)
      out[f'train_step_{name}_device_ms'] = _event_ms(fn, 20, warmup=3)
    finally:
      fused_bn.set_enabled(None)
  out['train_lists_per_s'] = B / out['train_step_fused_host_ms'] * 1e3
  return out, fn


def main():
  import torch
  if not torch.cuda.is_available():
    print('chip_smoke: CUDA is not available; this script runs on the card',
          file=sys.stderr)
    return 1
  from ranking_tpu_torch.data import dataset
  from ranking_tpu_torch.models import layers
  from ranking_tpu_torch.ops.cuda import build
  from ranking_tpu_torch.ops.cuda import fused_bn
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

  # Phase 2: build, one nvcc per source, side by side.
  t0 = time.perf_counter()
  build.compile_libraries(['sort', 'fused_bn_fwd', 'fused_bn_bwd'])
  cuda_sort._kernel()
  fused_bn.build_kernels()
  build_s = time.perf_counter() - t0
  _log(f'build: 3 kernel sources in {build_s:.2f} s ('
       + ', '.join(f'{k} {v:.1f} s' for k, v in build.BUILD_SECONDS.items())
       + ')')

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

  # Phase 3b, 3c: the fused masked-BN functions and the whole op.
  fused_errs = _check_fused_kernels(gen)
  _check_fused_op(gen)

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
  # Phases 7-9: training, the second path, and their times.
  train_counts, state, train_step, train_batch = _train_main_path(
      gen, eval_batches, fns)
  second_counts = _second_path(gen)
  fused_times = _time_fused(gen)
  train_times, train_fn = _time_train_step(state, train_step, train_batch)
  timings = {
      'build_s': build_s,
      'fused': fused_times, **train_times,
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
    for source in ('sort', 'fused_bn_fwd', 'fused_bn_bwd'):
      log = build.compile_library(source, ('-Xptxas', '-v')) + '.log'
      with open(log) as f:
        _log(f'ptxas {source}: ' + ' | '.join(
            line.strip()[:160] for line in f
            if 'registers' in line or 'spill' in line))
    for name, fn, host_ms in (
        ('eval_step', lambda: step(predictor.model, dev_batch, states),
         eval_step_ms),
        ('serve_b128', lambda: predictor.score_batch(requests[-1]),
         serve_ms),
        ('train_step', train_fn, train_times['train_step_fused_host_ms'])):
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
  # Rows 2-6. `ms`, `plain_ms` and `bound_ms` add up the calls that one
  # train step makes of the function (three layer shapes for the forward,
  # two for the backward products); `ms_by_shape` splits them. No single
  # PyTorch call computes what one of these functions computes, so there
  # is no library time.
  replaces = {'layer_forward': 155, 'bwd_stats': 226, 'bwd_mats': 356,
              'bwd_dx_only': 433, 'bwd_dw_only': 489}
  launches_of = dict(zip(replaces, train_counts))
  launches_of.update(second_counts)
  for name, line in replaces.items():
    t = fused_times[name]
    kernels.append({
        'name': name, 'route': 'cuda',
        'source': 'ranking_tpu_torch/ops/cuda/csrc/fused_bn_'
                  + ('fwd.cu' if name == 'layer_forward' else 'bwd.cu'),
        'replaces': f'ranking_tpu/ops/pallas/fused_bn.py:{line}',
        'launches': launches_of[name],
        'max_abs_err': fused_errs[name]['float32'][0],
        'max_rel_err': fused_errs[name]['float32'][1],
        'max_rel_err_bf16': fused_errs[name]['bfloat16'][1],
        'check': 'share of the largest value, FUSED_TOL',
        'ms': t['ms'], 'plain_ms': t['plain_ms'], 'bound_ms': t['bound_ms'],
        'bound_by': t['bound_by'], 'library_ms': None,
        'ms_by_shape': t['ms_by_shape']})
  print(card)
  print(json.dumps({'kernels': kernels}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
