"""The port's ``unbiased_two_tower`` CLI against the JAX CLI, on the CPU.

``make_click_log`` gives bitwise the JAX CLI's arrays. The JAX CLI runs
whole (``main``) at ``--queries=60 --steps=20``; the first state of each of
its two models (the naive click model and the two-tower model) is read off
its first step (through a stand-in for its module's ``jax`` that records
each jitted call) and carried over with ``convert.from_flax`` into the
port's ``TwoTower``. From there the port's ``train_model`` gives each
step's loss at rtol 1e-5 and atol 1e-5 (after one Adam step the parameters
agree within 1.2e-7; the float32 rounding grows to about 6e-6 of a loss
near 0.1 by step 20). ``true_ndcg`` gives the JAX CLI's two true NDCG@5
values from its trained weights, and the naive one from the port's, within
1e-6 + 1e-6 of the value; the port-trained two-tower model parts from the
JAX one at a ReLU gate within rounding of 0 at step 12 (see the test): its
parameters after step 11 agree at rtol and atol 1e-5, and its NDCG@5
within 1e-2. The default-size debiasing check runs on the
card (``chip_smoke.py`` phase 25g).
"""

import json
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

# Imported before the JAX CLI runs under its stand-in ``jax`` module, so
# that they bind the real one.
import ranking_tpu.models  # noqa: F401
import ranking_tpu.ops  # noqa: F401
import ranking_tpu.train  # noqa: F401

from ranking_tpu_torch import convert
from ranking_tpu_torch.examples import unbiased_two_tower as cli

import torch_cli_cases

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

# The JAX CLI initializes on the first batch_size queries, so it needs at
# least as many queries as --batch_size (its default 64 is more than 60).
ARGV = ['--queries=60', '--steps=20', '--batch_size=16']
# The last step before the two-tower model's ReLU gate within rounding of 0
# (see the test).
GATE_STEP = 11


def _run_jax_cli(monkeypatch):
  """Runs the JAX CLI's ``main``; returns (naive, debiased) and, for each
  model in turn, its first state's variables and each step's loss."""
  mod = torch_cli_cases.load_jax_cli('unbiased_two_tower')
  runs = []

  def jit(fn, **kwargs):
    jitted = jax.jit(fn, **kwargs)
    if getattr(fn, '__name__', None) != 'train_step':
      return jitted
    run = {'init': None, 'losses': []}
    runs.append(run)

    def call(state, batch, key):
      if run['init'] is None:   # before the donated state is consumed
        run['init'] = {'params': jax.tree_util.tree_map(np.array,
                                                        state.params)}
      state, metrics = jitted(state, batch, key)
      run['losses'].append(float(metrics['loss']))
      run['final'] = {'params': jax.tree_util.tree_map(np.array,
                                                       state.params)}
      if len(run['losses']) == GATE_STEP:
        run['before_gate'] = run['final']
      return state, metrics
    return call

  real_jax = jax

  class _Jax(types.ModuleType):
    def __getattr__(self, name):
      return getattr(real_jax, name)

  proxy = _Jax('jax')
  proxy.jit = jit
  monkeypatch.setitem(sys.modules, 'jax', proxy)
  monkeypatch.setattr(sys, 'argv', ['unbiased_two_tower.py'] + ARGV)
  try:
    naive, debiased = mod.main()
  finally:
    monkeypatch.setitem(sys.modules, 'jax', real_jax)
  return naive, debiased, runs, mod


def test_click_log_and_training_equal_the_jax_cli(monkeypatch, capsys):
  naive, debiased, runs, mod = _run_jax_cli(monkeypatch)
  jax_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert len(runs) == 2 and all(len(r['losses']) == 20 for r in runs)

  args = cli.parse_args(ARGV + ['--device=cpu'])
  log = cli.make_click_log(args)
  for got, want in zip(log, mod.make_click_log(args)):
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
  x, clicks, positions, true_labels = log
  split = args.queries * 4 // 5

  trained, from_jax = [], []
  for use_position, run in zip((False, True), runs):
    assert ('position_bias' in run['init']['params']) == use_position
    state = cli.make_state(args, use_position, 0, 'cpu')
    state.model.load_state_dict(convert.from_flax(run['init']), strict=True)
    back = convert.to_flax(state.model.state_dict())
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, run['init'])
    # The parameters after GATE_STEP steps, from the same first state.
    early = cli.make_state(args, use_position, 0, 'cpu')
    early.model.load_state_dict(convert.from_flax(run['init']), strict=True)
    early, _ = cli.train_model(
        cli.parse_args(ARGV + [f'--steps={GATE_STEP}', '--device=cpu']),
        early, x, clicks, positions, split, seed=0)
    jax.tree_util.tree_map(
        lambda got, want: np.testing.assert_allclose(got, want, rtol=1e-5,
                                                     atol=1e-5),
        convert.to_flax(early.model.state_dict()), run['before_gate'])
    state, losses = cli.train_model(args, state, x, clicks, positions, split,
                                    seed=0)
    np.testing.assert_allclose(losses, run['losses'], rtol=1e-5, atol=1e-5)
    trained.append(cli.true_ndcg(args, state, x, true_labels, split))
    state.model.load_state_dict(convert.from_flax(run['final']), strict=True)
    from_jax.append(cli.true_ndcg(args, state, x, true_labels, split))
  # The port's metric on the JAX CLI's trained weights, both models.
  np.testing.assert_allclose(from_jax, [naive, debiased], rtol=1e-6,
                             atol=1e-6)
  # Trained by the port: the naive model at the tolerance above. The
  # two-tower model's first-layer unit 30 meets a pre-activation of 7e-7 at
  # step 12, which rounds to an open ReLU gate in one package and a closed
  # one in the other; Adam then carries the unit apart (3.7e-3 by step 20)
  # and its NDCG@5 differs by 4.5e-3, while every step's loss stays within
  # the tolerance above. Its parameters are held at 1e-5 after step 11,
  # before the gate, and its NDCG@5 within 1e-2, about twice that gap.
  np.testing.assert_allclose(trained[0], naive, rtol=1e-6, atol=1e-6)
  assert abs(trained[1] - debiased) <= 1e-2, (trained[1], debiased)
  assert jax_line['naive_click_model_true_ndcg@5'] == round(naive, 4)

  # The port's own run prints the JAX CLI's line.
  got = cli.main(ARGV + ['--device=cpu'])
  line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert sorted(line) == sorted(jax_line)
  assert line['two_tower_debiased_true_ndcg@5'] == round(got[1], 4)



def _two_tower_tree():
  args = cli.parse_args(ARGV + ['--device=cpu'])
  named = cli.make_state(args, True, 0, 'cpu').model.state_dict()
  return named, convert.to_flax(named)


def test_names_outside_the_layouts_raise():
  """Only the tables beside a nested scorer keep their paths: a misnamed
  parameter raises, both ways."""
  named, tree = _two_tower_tree()
  table = named['position_bias.embedding']
  with pytest.raises(ValueError, match='not a parameter of a ported model'):
    convert.to_flax({'position_bias.embedding': table})
  stray = {k: v for k, v in named.items() if k != 'position_bias.embedding'}
  stray['position_bias.kernel'] = table
  with pytest.raises(ValueError, match='is not an embedding table'):
    convert.to_flax(stray)
  tree['params']['position_bias']['kernel'] = table.numpy()
  with pytest.raises(ValueError, match='is not an embedding table'):
    convert.from_flax(tree)
