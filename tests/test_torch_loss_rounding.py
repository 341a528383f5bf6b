"""Where float32 rounding changes a loss's answer, on the CPU.

Two losses of the zoo turn a rounding of their float32 intermediates into
a large change of the result, whatever computes them; ``chip_smoke.py``'s
loss check holds the card's float32 gradient to a float64 recompute that
takes the card's own decisions there (``_card_decisions``), and holds those
decisions on their own. These tests show both effects with the port's own
float32 and float64 runs:

* ``coupled_rankdistil_loss`` sorts float32 Gumbel-sampled teacher scores.
  Where two of them lie within rounding of each other (a near-tie built
  here), float32 and float64 order them differently; the loss is
  discontinuous there, so both answers are right, and its gradient jumps.
  The float32 orders invert the float64 scores by at most 2^-20 of their
  magnitude (the bound ``ZOO_TIE_GAP`` of ``chip_smoke.py``), and the
  float64 loss that takes the float32 orders agrees with the float32 one.
* ``gumbel_neural_sort_ndcg_loss`` feeds float32 Gumbel-sampled
  log-probabilities to NeuralSort, whose exponents multiply each one by a
  rank coefficient of up to L: one ulp of a sample moves the gradient of
  an ill-conditioned list by far more than float32 arithmetic does. The
  float64 recompute from the float32 samples agrees with the float32
  gradient within 1e-4 of its largest entry; from its own samples it does
  not (8.5e-3 on this seeded batch).

No JAX here: both sides are the port's.
"""

import contextlib
import os
from unittest import mock

import numpy as np
import torch

from ranking_tpu_torch.ops import loss_registry, sorting
from ranking_tpu_torch.utils import list_ops

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

TIE_GAP = 2.0 ** -20


@contextlib.contextmanager
def _decisions(replay=None):
  """Records each ``sort_by_scores`` call's order (with its float64 scores)
  and each ``gumbel_sample_lists`` call's sampled logits; with ``replay``,
  takes them from an earlier run instead (the samples as values only)."""
  sort_by_scores = list_ops.sort_by_scores
  sample_lists = sorting.gumbel_sample_lists
  record = {'sorts': [], 'samples': []}

  def sorts(scores, features_list, topn=None, **kwargs):
    if replay is not None:
      order = replay['sorts'][len(record['sorts'])][0]
      record['sorts'].append((order, None))
      return [list_ops.gather_per_row(f, order) for f in features_list]
    positions = torch.arange(scores.shape[1], dtype=torch.float32).expand(
        scores.shape)
    *out, order = sort_by_scores(scores, list(features_list) + [positions],
                                 topn=topn, **kwargs)
    record['sorts'].append((order.to(torch.int64), scores.detach().double()))
    return out

  def samples(*args, **kwargs):
    labels, logits, weights = sample_lists(*args, **kwargs)
    if replay is not None:
      card = replay['samples'][len(record['samples'])]
      logits = logits + (card.to(logits.dtype) - logits).detach()
    record['samples'].append(logits.detach())
    return labels, logits, weights

  with mock.patch.object(list_ops, 'sort_by_scores', sorts), \
      mock.patch.object(sorting, 'gumbel_sample_lists', samples):
    yield record


def _batch(seed, b, l):
  rng = np.random.RandomState(seed)
  logits = torch.from_numpy((rng.randn(b, l) * 0.55).astype(np.float32))
  labels = torch.from_numpy(rng.randint(0, 5, (b, l)).astype(np.float32))
  n = torch.from_numpy(rng.randint(20, l + 1, b))
  labels[torch.arange(l)[None] >= n[:, None]] = -1.0
  return labels, logits


def _value_and_grad(fn, labels, logits, dtype, replay=None):
  x = logits.to(dtype).clone().requires_grad_()
  with _decisions(replay) as record:
    value = fn(labels.to(dtype), x)
  value.backward()
  return value.item(), x.grad.double(), record


def test_crd_near_tie_is_ordered_within_rounding_and_the_loss_jumps():
  """A built near-tie: the two lowest teacher labels (0 and 0) get Gumbel
  noise one float32 ulp apart, so that their sampled teacher scores lie
  within rounding of each other and the two runs order them differently
  (the kept tie draws order a tie); their students are far apart (-2 and
  3)."""
  fn = loss_registry.make_loss_fn('coupled_rankdistil_loss')
  labels = torch.tensor([[2.0, 1.0, 0.0, 0.0]])
  logits = torch.tensor([[1.0, 0.5, -2.0, 3.0]])
  noise = torch.zeros(1, 8, 4)           # the default 8 samples a list
  noise[..., 3] = 2.0 ** -23
  with mock.patch.object(sorting, 'sample_gumbel',
                         lambda *args, **kwargs: noise.clone()):
    v32, g32, f32 = _value_and_grad(fn, labels, logits, torch.float32)
    _, g64, f64 = _value_and_grad(fn, labels, logits, torch.float64)
    r64, rg64, _ = _value_and_grad(fn, labels, logits, torch.float64,
                                   replay=f32)
  (order32, _), = f32['sorts']
  (order64, scores), = f64['sorts']
  rows = (order32 != order64).any(dim=1)
  # Some samples are sorted otherwise, only at the near-tie, and the
  # float32 orders invert no float64 scores by more than rounding. (The
  # sort itself takes float32 keys, so float64's keys of items 2 and 3 may
  # tie there and go by the tie draws.)
  assert 0 < int(rows.sum()) < 8
  assert set(torch.nonzero(order32 != order64)[:, 1].tolist()) == {2, 3}
  pair = scores[:, 2:]
  assert float(((pair[:, 0] - pair[:, 1]).abs()
                / pair.abs().max(dim=1).values).max()) <= TIE_GAP
  s = torch.gather(scores[rows], 1, order32[rows])
  gap = (s[:, 1:] - s[:, :-1]) / torch.clamp(
      torch.maximum(s[:, 1:].abs(), s[:, :-1].abs()), min=1.0)
  assert float(gap.max()) <= TIE_GAP
  # The loss jumps there: with its own orders, float64's gradient is far
  # from float32's; with the float32 orders it is float32's.
  assert (g32 - g64).abs().max() / g64.abs().max() > 0.1
  assert abs(r64 - v32) <= 1e-6 * abs(r64)
  assert (g32 - rg64).abs().max() / rg64.abs().max() <= 1e-6


def test_gumbel_neural_sort_ndcg_gradient_follows_the_rounding_of_samples():
  fn = loss_registry.make_loss_fn('gumbel_neural_sort_ndcg_loss')
  labels, logits = _batch(0, 16, 200)
  _, g32, f32 = _value_and_grad(fn, labels, logits, torch.float32)
  _, g64, f64 = _value_and_grad(fn, labels, logits, torch.float64)
  # The samples themselves agree to within a few float32 ulps ...
  for s32, s64 in zip(f32['samples'], f64['samples']):
    assert ((s32.double() - s64).abs() / (1.0 + s64.abs())).max() < 1e-6
  # ... but the gradient from float64's own samples is far from float32's,
  scale = g64.abs().max()
  assert (g32 - g64).abs().max() / scale > 1e-3
  # and the float64 recompute from the float32 samples is not.
  _, rg64, _ = _value_and_grad(fn, labels, logits, torch.float64,
                               replay=f32)
  assert (g32 - rg64).abs().max() / rg64.abs().max() <= 1e-4
