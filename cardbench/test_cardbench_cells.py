"""Each cell driven end to end on the CPU at small sizes, sound and with
the timed path broken underneath; and, on the card, each cell's control.

Run: ``python -m pytest cardbench/test_cardbench_cells.py`` (the ``cuda``
case on a machine with the card).
"""

import time

import numpy as np
import pytest
import torch

from cardbench import harness, small
from ranking_tpu_torch.ops.cuda import fused_bn

CELLS = [w['name'] for w in harness.benchmark()['workloads']]
TRAIN = [c for c in CELLS if small.ctx(c)[1].traffic['kind'] == 'train']
# At the small sizes the sound runs read under 1e-5 in every number but a
# tiny model's round-off leaves; each planted fault reads 0.1 or more.
SMALL_LIMIT = 0.05


@pytest.fixture(autouse=True)
def fused_tower():
  """The fused masked-BN tower's semantics on the CPU, as on the card."""
  fused_bn.set_enabled(True)
  yield
  fused_bn.set_enabled(None)


def _run(cell, trace=False, seed=2**31 + 7):
  bench, ctx = small.ctx(cell, seed=seed, trace=trace)
  limits = {k: SMALL_LIMIT for k in harness.limits_of(cell)}
  return harness.run(bench, ctx, limits, time.time())


@pytest.mark.parametrize('trace', [False, True])
@pytest.mark.parametrize('cell', CELLS)
def test_cell_is_correct_and_reports_its_metrics(cell, trace):
  bench = harness.benchmark()
  out = _run(cell, trace)
  assert out['correct'], out['checks']
  assert out['failed'] == 0 and out['attempted'] > 0
  assert list(out)[-1] == 'checks'
  if trace:
    # On the CPU only the spans and counters have something to read.
    names = {m['name'] for m in harness.per_layer_of(bench, cell)
             if m['source'] != 'device_trace'}
  else:
    names = {m['name'] for m in harness.end_to_end_of(bench, cell)}
  assert set(out['metrics']) == names
  assert all(np.isfinite(m['value']) and m['value'] > 0
             for m in out['metrics'].values())


@pytest.mark.parametrize('cell', TRAIN)
def test_a_state_left_unchanged_is_caught(cell, monkeypatch):
  from ranking_tpu_torch.train import state
  monkeypatch.setattr(state.TrainState, 'apply_gradients', lambda self: None)
  out = _run(cell)
  assert not out['correct']
  change = [c['value'] for k, c in out['checks'].items()
            if k.startswith('change')]
  assert change and change == pytest.approx([1.0] * len(change))


@pytest.mark.parametrize('cell', TRAIN)
def test_half_of_each_batch_left_out_is_caught(cell, monkeypatch):
  import importlib
  _, ctx = small.ctx(cell)
  loss = importlib.import_module(f"cardbench.losses.{ctx.traffic['loss']}")
  program = loss.program

  def half_batch_program():
    fn = program()

    def half(labels, logits, features=None, generator=None):
      b = labels.shape[0] // 2
      return fn(labels[:b], logits[:b], features=features,
                generator=generator)
    return half

  monkeypatch.setattr(loss, 'program', half_batch_program)
  assert not _run(cell)['correct']


def test_an_altered_answer_is_caught(monkeypatch):
  from ranking_tpu_torch.pipeline import serving
  predict = serving.Predictor.predict

  def altered(self, requests):
    scores = predict(self, requests)
    scores[0, 0] += 0.1 * np.abs(scores[0]).max()
    return scores

  monkeypatch.setattr(serving.Predictor, 'predict', altered)
  out = _run('tfr_bert.serve_rerank')
  assert not out['correct']
  assert out['checks']['score_gap']['value'] > SMALL_LIMIT


@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA card: the control computes through TF32')
  return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('cell', CELLS)
def test_the_control_fails_a_number(cell, card):
  """The reference through TF32 in the program's place, at the cell's own
  size on one seed, fails at least one of the cell's limits."""
  bench = harness.benchmark()
  ctx = harness.make_ctx(bench, cell, 2**31 + 11, 1.0, False, card)
  controls = harness.kind_of(ctx).Cell(ctx).controls()
  limits = harness.limits_of(cell)
  assert any(controls['control_tf32'][k] > limits[k] for k in limits), (
      controls, limits)


@pytest.mark.cuda
@pytest.mark.parametrize('cell', TRAIN)
def test_a_replay_that_leaves_the_state_unchanged_is_caught(cell, card):
  """At the cell's own size on the card: the steps replayed from the CUDA
  graph put the state back as they found it, and ``correct`` comes out
  false. The same run without the fault is correct."""
  from cardbench import faults
  bench = harness.benchmark()
  limits = harness.limits_of(cell)
  sound = harness.run(bench, harness.make_ctx(
      bench, cell, 2**31 + 13, 1.0, False, card), limits, time.time())
  assert sound['correct'], sound['checks']
  with faults.replay_leaves_state_unchanged():
    out = harness.run(bench, harness.make_ctx(
        bench, cell, 2**31 + 13, 1.0, False, card), limits, time.time())
  assert not out['correct']
  assert any(c['value'] > c['limit'] for c in out['checks'].values())
