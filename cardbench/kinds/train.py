"""Training cells: K steps a dispatch through the port's ``make_multi_step``
(``GraphedSteps``: one step captured as a CUDA graph and replayed), fed as
``SimplePipeline`` feeds it: each dispatch's batches flattened
(``flatten_examples``), stacked into page-locked memory
(``stack_numpy_batches``) and copied ahead by ``prefetch_to_device``.

Set-up builds the one train state and multi-step object that the window
drives, and runs its first steps through the window's own call on rows
that all differ: a dispatch of one step, whose gradients the optimizer
consumed are read; one of the rest of the graph's eager warm-up steps
(``GraphedSteps.warmup``); and one of ``REPLAYS`` steps, which capture the
graph and replay it, as every step of the window does. Then the
parameters are read. The reference follows all of those steps from the
same weights and rows.

Compared (``compare``): each step's loss; each step's mean logit over the
valid documents (the train step's ``logits_mean``), against the root mean
square of the reference's logits; each leaf's first gradient norm; where
the model has batch normalization, each layer's running mean after the
first step (its first batch mean, which no later step or rank decides),
elementwise against the larger reference value; each leaf's change over
all the steps, leaving out the leaves whose reference gradient is under a
thousandth of the median leaf's (they move by round-off alone). A norm's
gap is taken against the larger of the leaf's reference norm and the
median leaf's. The mean logit is the steady one: a ranking loss whose
weights follow the documents' ranks (LambdaRank) moves its loss and
gradients by a step wherever float32 rounding orders two near-tied
documents otherwise (PERF.md).
"""

from __future__ import annotations

import collections
import importlib
import math
from typing import Dict, List

import numpy as np
import torch

from cardbench.reference import precision
from cardbench.reference import train as ref_train

# Leaves whose reference gradient norm is under this share of the median
# leaf's are left out of the change.
ROUNDOFF_LEAF = 1e-3
# Steps replayed from the captured graph among the compared ones.
REPLAYS = 3
# The eager warm-up steps of a multi-step object that does not say.
WARMUP = 3


class BatchOrder:
  """Rows of the in-memory pool, batch after batch: consecutive slices of
  the pool (its rows are independent draws), over and over, so that the
  rows of consecutive batches differ and a batch is a view, not a copy."""

  def __init__(self, num_lists: int, batch_size: int):
    if num_lists % batch_size:
      raise ValueError(f'pool_lists {num_lists} is not a multiple of the '
                       f'batch size {batch_size}')
    self.n, self.b, self.at = num_lists, batch_size, 0

  def next(self) -> slice:
    out = slice(self.at, self.at + self.b)
    self.at = (self.at + self.b) % self.n
    return out


def _gather(examples, labels, idx):
  return {k: v[idx] for k, v in examples.items()}, labels[idx]


def _norm(t: torch.Tensor) -> float:
  return float(torch.linalg.vector_norm(t.detach().double()))


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves=None) -> List[float]:
  """Each leaf's |prog norm - ref norm| over the larger of its ref norm
  and the median leaf's."""
  leaves = list(ref) if leaves is None else list(leaves)
  median = float(np.median([ref[k] for k in ref]))
  return [abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
          for k in leaves]


class Cell:
  def __init__(self, ctx):
    self.ctx = ctx
    cfg, tr = ctx.config, ctx.traffic
    self.fam = ctx.family
    self.loss = importlib.import_module(f"cardbench.losses.{tr['loss']}")
    self.k = tr['steps_per_dispatch']
    self.examples, self.labels = self.fam.make_lists(
        cfg, tr, ctx.seed, tr['pool_lists'])
    self.order = BatchOrder(tr['pool_lists'], tr['batch_size'])
    self.first: List[slice] = []   # the rows of the compared steps
    self.warmup = WARMUP
    self.readings: Dict[str, object] = {}
    self._pending = collections.deque()  # (lists, flops, documents) a dispatch

  # -- the program -----------------------------------------------------------

  def _host_batch(self, record: bool):
    from ranking_tpu_torch.data.batch import RankingBatch
    idx = self.order.next()
    if record:
      self.first.append(idx)
    ex, lab = _gather(self.examples, self.labels, idx)
    return RankingBatch(context={},
                        examples={k: torch.from_numpy(v) for k, v in ex.items()},
                        labels=torch.from_numpy(lab),
                        mask=torch.from_numpy(lab >= 0)), (ex, lab)

  def _dispatches(self, plan):
    """The host side of each dispatch: K batches flattened and stacked in
    page-locked memory (on CUDA)."""
    from ranking_tpu_torch.data import batch as batch_lib
    from ranking_tpu_torch.data import dataset
    pin = self.ctx.device.type == 'cuda'
    for k in plan:
      with self.ctx.spans('feed'):
        batches, arrays = [], []
        for _ in range(k):
          b, host = self._host_batch(
              record=len(self.first) < self.warmup + REPLAYS)
          batches.append(dataset.flatten_examples(b))
          arrays.append(host)
        stacked = batch_lib.stack_numpy_batches(batches, pin_memory=pin)
      self._pending.append((
          sum(lab.shape[0] for _, lab in arrays),
          sum(self.fam.train_flops(self.ctx.config, ex, lab)
              for ex, lab in arrays),
          sum(float((lab >= 0).sum()) for _, lab in arrays)))
      yield stacked

  def _plan(self):
    yield 1
    if self.warmup > 1:
      yield self.warmup - 1
    yield REPLAYS
    while True:
      yield self.k

  def setup(self):
    from ranking_tpu_torch.data import dataset
    from ranking_tpu_torch.train import state as state_lib
    from ranking_tpu_torch.train import steps
    ctx, cfg, tr = self.ctx, self.ctx.config, self.ctx.traffic
    dev = ctx.device
    weights = self.fam.draw_weights(cfg, ctx.seed, dev)
    model = self.fam.build(cfg, weights, dev)
    del weights
    opt = tr['optimizer']
    factory = getattr(state_lib, opt['name'])(
        **{k: v for k, v in opt.items() if k != 'name'})
    self.state = state_lib.create_train_state(model, factory, device=dev)
    self.multi = steps.make_multi_step(
        steps.make_train_step(self.loss.program(), device=dev), device=dev)
    self.warmup = max(1, getattr(self.multi, 'warmup', WARMUP))
    self.generator = torch.Generator(dev).manual_seed(
        int(ctx.seed) % 2**63)
    self.feed = dataset.prefetch_to_device(self._dispatches(self._plan()),
                                           dev)
    leaves = self.fam.leaf_params(cfg, self.state.model)
    start = {k: p.detach().clone() for k, p in leaves.items()}
    losses, means = self._step()                       # step 1
    self.readings['grad'] = {k: _norm(p.grad) for k, p in leaves.items()}
    self.readings['stats'] = {
        k: v.detach().double().cpu().numpy()
        for k, v in self.fam.running_means(cfg, self.state.model).items()}
    for _ in range(2 if self.warmup > 1 else 1):   # warm-up, then replays
      more = self._step()
      losses, means = losses + more[0], means + more[1]
    if getattr(self.multi, 'replays', REPLAYS) != REPLAYS:
      raise RuntimeError(
          f'{self.multi.replays} of the compared steps were graph replays, '
          f'not {REPLAYS}')
    self.readings['loss'], self.readings['logits_mean'] = losses, means
    self.readings['change'] = {k: _norm(p.detach() - start[k])
                               for k, p in leaves.items()}
    del start
    self.last_loss = None

  def _step(self):
    """One dispatch; its per-step losses and mean logits, on the host."""
    self.state, metrics = self.multi(self.state, next(self.feed),
                                     self.generator)
    self._pending.popleft()
    return ([float(x) for x in metrics['loss'].cpu()],
            [float(x) for x in metrics['logits_mean'].cpu()])

  def window(self, win):
    ctx = self.ctx
    c = ctx.counters
    steps = 0
    while win.tick():
      with ctx.spans('dispatch'):
        self.state, metrics = self.multi(self.state, next(self.feed),
                                         self.generator)
      lists, flops, docs = self._pending.popleft()
      c['steps'] += self.k
      c['lists'] += lists
      c['model_flops'] += flops
      c['valid_docs'] += docs
      steps += self.k
      self.last_loss = metrics['loss']
    seconds = win.close()
    losses = self.last_loss.cpu()
    failed = int((~torch.isfinite(losses)).sum())
    return {'train_lists_per_s': c['lists'] / seconds}, steps, failed

  def free(self):
    self.state = self.multi = self.feed = self.generator = None
    self.last_loss = None
    if self.ctx.device.type == 'cuda':
      torch.cuda.empty_cache()

  def program_readings(self):
    return self.readings

  # -- the reference ---------------------------------------------------------

  def reference_readings(self, tf32: bool = False, fault: str = None):
    """The reference's readings of the compared steps. ``fault``
    'half_batch' leaves out the second half of each batch's lists (the
    loss is then the mean over the rest)."""
    ctx, cfg, tr = self.ctx, self.ctx.config, self.ctx.traffic
    dev = ctx.device
    batches = []
    for idx in self.first:
      if fault == 'half_batch':
        idx = slice(idx.start, idx.start + (idx.stop - idx.start) // 2)
      ex, lab = _gather(self.examples, self.labels, idx)
      batches.append(({k: torch.from_numpy(v).to(dev) for k, v in ex.items()},
                      torch.from_numpy(lab).to(dev)))
    fam, loss = self.fam, self.loss

    stats = {}   # the first step's running means

    def loss_of(w, batch):
      ex, lab = batch
      first_step = not stats
      logits = fam.reference_logits(cfg, w, ex, lab, True,
                                    stats=stats if first_step else None)
      return loss.reference(lab, logits), logits, lab >= 0

    weights = fam.draw_weights(cfg, ctx.seed, dev)
    with precision(tf32):
      losses, logit_stats, first, trained = ref_train.steps(
          loss_of, weights, fam.trainable(cfg), batches,
          ref_train.make_optimizer(tr['optimizer']))
    return {'loss': losses,
            'logits_mean': [m for m, _ in logit_stats],
            'logits_rms': [r for _, r in logit_stats],
            'stats': {k: v.double().cpu().numpy() for k, v in stats.items()},
            'grad': {k: _norm(g) for k, g in first.items()},
            'change': {k: _norm(trained[k] - weights[k]) for k in trained}}

  def controls(self) -> Dict[str, Dict[str, float]]:
    """The compared numbers of the control (the reference through TF32 in
    the program's place) and of a planted fault (half of each batch left
    out), each against the reference, with no program run."""
    if not self.first:
      order = BatchOrder(self.labels.shape[0],
                         self.ctx.traffic['batch_size'])
      self.first = [order.next() for _ in range(self.warmup + REPLAYS)]
    ref = self.reference_readings()
    return {'control_tf32': self.compare(self.reference_readings(tf32=True),
                                         ref),
            'fault_half_batch': self.compare(
                self.reference_readings(fault='half_batch'), ref)}

  def compare(self, prog, ref) -> Dict[str, float]:
    """Every number a train cell can compare; the cell's limits file
    names those it does. ``loss1_gap``: the first step's loss alone, for a
    loss whose later steps follow rank flips (PERF.md)."""
    grads = ref['grad']
    median = float(np.median(list(grads.values())))
    moving = [k for k in grads if grads[k] >= ROUNDOFF_LEAF * median]
    losses = [abs(p - r) / max(abs(r), 1e-30)
              for p, r in zip(prog['loss'], ref['loss'])]
    if not all(math.isfinite(x) for x in prog['loss']):
      losses = [math.inf]
    logit_gap = max(abs(p - r) / max(rms, 1e-30) for p, r, rms in zip(
        prog['logits_mean'], ref['logits_mean'], ref['logits_rms']))
    if not all(math.isfinite(x) for x in prog['logits_mean']):
      logit_gap = math.inf
    grad = leaf_gaps(prog['grad'], grads)
    change = leaf_gaps(prog['change'], ref['change'], moving)
    out = {'loss_gap': max(losses), 'loss1_gap': losses[0],
           'logit_gap': logit_gap, 'grad_gap': max(grad),
           'change_gap': max(change)}
    if ref['stats']:
      out['stats_gap'] = max(
          float(np.max(np.abs(prog['stats'][k] - r))) / max(
              float(np.max(np.abs(r))), 1e-30)
          for k, r in ref['stats'].items())
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}
