"""The port's ``ranking_libsvm`` CLI against the JAX CLI, on the CPU.

Both CLIs run whole (``main``) on one LIBSVM file set that the test
writes, at tiny widths with ``--dropout=0``. The JAX CLI starts from
``build_model(args)`` at ``PRNGKey(0)``; its first train state is read off
its first step (through a stand-in for its module's ``jax`` that records
each jitted call) and carried over with ``convert.from_flax`` into the port
CLI's model (its ``build_model`` stands in for the same), so the two loops
start from the same weights. Over 30 steps each step's loss agrees at rtol
1e-5 and the validation and test metrics at 1e-5: for the default
``pairwise_logistic_loss`` and for ``--lambda_ndcg --group_size=2``. Both
packages run their unfused paths on the CPU; the groupwise scorer's
training shuffles take one set of draws in both (``_same_shuffles``). The
port's export reloads
bitwise. For ``--scorer=gam`` the JAX model's variables load strictly into
the port's (and ``convert.to_flax`` gives them back) and the eval-mode
forward agrees at 1e-5.
"""

import os
import re
import sys
import types

import jax
import numpy as np
import pytest
import torch

from ranking_tpu_torch import convert
from ranking_tpu_torch.data import libsvm
from ranking_tpu_torch.examples import ranking_libsvm as cli
from ranking_tpu_torch.train import checkpoint

from torch_cli_cases import load_jax_cli

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

F, LIST = 6, 8
STEPS = 30
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope='module')
def files(tmp_path_factory):
  d = tmp_path_factory.mktemp('libsvm_cli')
  for name, lists, seed in (('train', 40, 0), ('vali', 10, 1),
                            ('test', 7, 2)):
    libsvm.write_random_lists(str(d / f'{name}.txt'), lists, F, 3, LIST,
                              seed=seed)
  return d


def _argv(files, out, extra=()):
  return [f'--train_path={files / "train.txt"}',
          f'--vali_path={files / "vali.txt"}',
          f'--test_path={files / "test.txt"}', f'--output_dir={out}',
          f'--num_features={F}', f'--list_size={LIST}', '--batch_size=4',
          f'--num_train_steps={STEPS}', '--eval_every=10',
          '--hidden_layer_dims=8,4', '--dropout=0', *extra]


def _numpy_tree(tree):
  return jax.tree_util.tree_map(lambda x: np.array(x), tree)


def _run_jax_cli(monkeypatch, argv):
  """Runs the JAX CLI's ``main``; returns its first state's variables, each
  step's loss, its evaluations in order, and what it printed."""
  mod = load_jax_cli('ranking_libsvm')
  record = {'init': None, 'losses': [], 'evals': []}

  def jit(fn, **kwargs):
    jitted = jax.jit(fn, **kwargs)
    if fn.__name__ != 'train_step':
      return jitted

    def call(state, batch, key):
      if record['init'] is None:   # before the donated state is consumed
        record['init'] = {'params': _numpy_tree(state.params),
                          'batch_stats': _numpy_tree(state.batch_stats)}
      state, metrics = jitted(state, batch, key)
      record['losses'].append(float(metrics['loss']))
      return state, metrics
    return call

  evaluate = mod.evaluate

  def recording_evaluate(*args):
    out = evaluate(*args)
    record['evals'].append(out)
    return out

  monkeypatch.setattr(mod, 'jax', types.SimpleNamespace(
      jit=jit, random=jax.random))
  monkeypatch.setattr(mod, 'evaluate', recording_evaluate)
  # Its Orbax export is not compared (the port's reloads bitwise, below);
  # it would take most of the run.
  from ranking_tpu.train import checkpoint as jax_checkpoint
  monkeypatch.setattr(jax_checkpoint, 'export_params', lambda *a: None)
  monkeypatch.setattr(sys, 'argv', ['ranking_libsvm.py'] + list(argv))
  mod.main()
  return record


def _run_port_cli(monkeypatch, argv, variables):
  """Runs the port CLI's ``main`` from the JAX CLI's first state."""
  build = cli.build_model

  def converted(args, generator=None):
    model = build(args, generator)
    model.load_state_dict(convert.from_flax(variables), strict=True)
    return model

  monkeypatch.setattr(cli, 'build_model', converted)
  return cli.main(list(argv) + ['--device=cpu'])


def _same_shuffles(monkeypatch):
  """The groupwise scorer shuffles each list's valid items in training,
  by ``[B, L]`` uniform draws of the step's key (the same key every step in
  the JAX CLI, so the same draws) or of the port's reseeded generator: both
  packages take one set of draws instead."""
  from ranking_tpu_torch.models import groupwise
  draws = np.random.RandomState(5).rand(4, LIST).astype(np.float32)
  uniform = jax.random.uniform

  def fixed_uniform(key, shape=(), *args, **kwargs):
    if tuple(shape) == draws.shape:
      return jax.numpy.asarray(draws)
    return uniform(key, shape, *args, **kwargs)

  monkeypatch.setattr(jax.random, 'uniform', fixed_uniform)
  forward = groupwise.GroupwiseDNNScorer.forward

  def fixed_forward(self, *args, shuffle_draws=None, **kwargs):
    if kwargs.get('training'):
      shuffle_draws = torch.from_numpy(draws)[None]
    return forward(self, *args, shuffle_draws=shuffle_draws, **kwargs)

  monkeypatch.setattr(groupwise.GroupwiseDNNScorer, 'forward', fixed_forward)


def _numbers(line):
  return {k: float(v) for k, v in re.findall(r'(\S+)=([-0-9.]+)', line)}


@pytest.mark.parametrize('extra', [(), ('--lambda_ndcg', '--group_size=2')],
                         ids=['pairwise_logistic', 'lambda_groupwise'])
def test_thirty_steps_equal_the_jax_cli(files, tmp_path, monkeypatch, capsys,
                                        extra):
  if '--group_size=2' in extra:
    _same_shuffles(monkeypatch)
  jax_run = _run_jax_cli(monkeypatch, _argv(files, tmp_path / 'jax', extra))
  jax_out = capsys.readouterr().out.replace(str(tmp_path / 'jax'),
                                            str(tmp_path / 'port'))
  got = _run_port_cli(monkeypatch, _argv(files, tmp_path / 'port', extra),
                      jax_run['init'])
  port_out = capsys.readouterr().out

  assert len(got['losses']) == len(jax_run['losses']) == STEPS
  np.testing.assert_allclose(got['losses'], jax_run['losses'], **TOL)
  # Validation at steps 10, 20 and 30, then the test split.
  want_vali, want_test = jax_run['evals'][:-1], jax_run['evals'][-1]
  assert sorted(got['vali']) == [10, 20, 30]
  for step, want in zip(sorted(got['vali']), want_vali):
    assert sorted(got['vali'][step]) == sorted(want)
    for k in want:
      np.testing.assert_allclose(got['vali'][step][k], want[k], **TOL)
  for k in want_test:
    np.testing.assert_allclose(got['test'][k], want_test[k], **TOL)

  # The same lines, their numbers to the printed 4 decimals.
  def lines(out):
    return [l for l in out.splitlines()
            if l.startswith(('step ', 'test:', 'exported', 'train queries'))]
  jax_lines, port_lines = lines(jax_out), lines(port_out)
  assert len(port_lines) == len(jax_lines) == 6
  for p, j in zip(port_lines, jax_lines):
    assert p.split(':')[0] == j.split(':')[0]
    pn, jn = _numbers(p), _numbers(j)
    assert sorted(pn) == sorted(jn)
    for k in jn:
      assert abs(pn[k] - jn[k]) <= 1.5e-4, (p, j)

  # The export reloads bitwise.
  export = checkpoint.load_params(str(tmp_path / 'port' / 'export'))
  live = got['state'].model.state_dict()
  assert sorted(export) == sorted(live)
  for k, v in live.items():
    assert torch.equal(export[k], v), k


def test_gam_converts_strictly_and_scores_as_jax(files, monkeypatch):
  argv = _argv(files, 'unused', ['--scorer=gam'])
  mod = load_jax_cli('ranking_libsvm')
  monkeypatch.setattr(sys, 'argv', ['ranking_libsvm.py'] + argv)
  jargs = mod.parse_args()
  x, y, _ = libsvm.load_libsvm_lists(str(files / 'vali.txt'), LIST, F)
  mask = y >= 0
  jmodel = mod.build_model(jargs)
  examples = {'float_features': x}
  # Jitted: flax's eager init and apply would compile each operation.
  variables = _numpy_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(0), {},
                                               examples, mask))
  assert len(variables['params']['scorer']['GAMScorer_0']['GAMLayer_0']) == F

  model = cli.build_model(cli.parse_args(argv + ['--device=cpu']))
  state = convert.from_flax(variables)
  model.load_state_dict(state, strict=True)
  back = convert.to_flax(model.state_dict())
  jax.tree_util.tree_map(np.testing.assert_array_equal, back, variables)

  want = np.asarray(jax.jit(lambda v, e, m: jmodel.apply(
      v, {}, e, m, training=False))(variables, examples, mask))
  with torch.no_grad():
    got = model({}, {'float_features': torch.from_numpy(x)},
                torch.from_numpy(mask), training=False).numpy()
  np.testing.assert_allclose(got, want, **TOL)


def test_each_step_draws_from_the_same_seed(files, tmp_path, monkeypatch):
  """The JAX CLI passes its one key to every step, so the port's loop
  reseeds its step generator before each step: at ``--dropout=0.5`` every
  step draws the same masks."""
  states = []
  from ranking_tpu_torch.train import steps
  original = steps.make_train_step

  def recording(loss_fn, **kwargs):
    step = original(loss_fn, **kwargs)

    def call(state, batch, generator):
      states.append(generator.get_state().clone())
      return step(state, batch, generator)
    return call

  monkeypatch.setattr(steps, 'make_train_step', recording)
  # The later flags win: dropout 0.5, 3 steps.
  argv = _argv(files, tmp_path / 'out', ['--dropout=0.5',
                                         '--num_train_steps=3'])
  cli.main(argv + ['--device=cpu'])
  assert len(states) == 3
  seeded = torch.Generator().manual_seed(cli.STEP_SEED).get_state()
  assert all(torch.equal(s, seeded) for s in states)
