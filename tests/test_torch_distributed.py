"""The port's data-parallel steps == the JAX single-device steps on the
global batch, over gloo ranks on the CPU.

The JAX package's semantics under a mesh are those of one device holding
the whole global batch. So every case here runs the JAX step on one device
on the global batch, converts its weights (``convert.from_flax``), and
holds the port's ranks (``tests/torch_dist_cases.py``; one
``torch.multiprocessing`` spawn, world 2 (``data=2``) and world 4
(``data=2 x model=2``) at once) against it:

* the DNN train step on the fused plain path and on the unfused path, two
  steps on batches whose two halves hold 31 and 9 valid documents (the
  case where a mean of per-rank means is wrong), and a
  ``unique_softmax_loss`` step (its fill is the global batch's minimum);
* the eval step's metrics and validation loss, with a ragged batch padded
  to the data axis and weighted off by ``num_valid_rows``.

The ranks start first and run while this process computes the JAX steps.
``tests/test_torch_distributed_sharded.py`` holds the model-sharded steps.

Tolerances, as ``tests/test_torch_train.py`` derives them: the loss and
metrics rtol 1e-5 atol 1e-6, parameters atol 5e-6 (float32 sums over other
orders, here also over ranks, chained through a backward), batch
statistics atol 1e-6. The dense Adam runs at eps 1e-3, for that file's
reason.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ranking_tpu import ops as jax_ops
from ranking_tpu.data import batch as jax_batch
from ranking_tpu.models import scorers as jax_scorers
from ranking_tpu.ops import metric_registry as jax_metrics
from ranking_tpu.ops.pallas import fused_bn as jfb
from ranking_tpu.train import state as jax_state
from ranking_tpu.train import steps as jax_steps
from ranking_tpu_torch import convert

import torch_dist_cases
from torch_dist_refs import WORLDS, assert_tree_close, case, close, grid
from torch_dist_refs import randomized

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

B, L, F = 8, 6, 8
HIDDEN = (16, 8)


# --------------------------------------------------------- JAX references


def _dnn_batches(num, seed):
  """Batches whose first half (rank 0's rows at data=2) holds many valid
  documents and whose second half few."""
  rng = np.random.RandomState(seed)
  out = []
  for _ in range(num):
    keep = np.concatenate([rng.rand(B // 2, L) > 0.1,
                           rng.rand(B // 2, L) > 0.75])
    keep[:, 0] = True
    labels = np.where(keep, rng.randint(0, 5, (B, L)), -1).astype(np.float32)
    labels[1] = np.where(keep[1], 0.0, -1.0)   # a list with no relevant item
    out.append((rng.randn(B, L, F).astype(np.float32) * 2, labels, keep))
  return out


def _jax_dnn(batches, loss_key, fused):
  """Randomized weights, and a function that runs the JAX DNN train steps
  from them on the global batches: (per-step metrics, final variables)."""
  jfb.set_enabled(fused)
  try:
    model = jax_scorers.RankingModel(
        scorer=jax_scorers.DNNScorer(hidden_layer_dims=HIDDEN, dropout=0.0,
                                     input_grad=False),
        transform_name='log1p')
    x0, _, m0 = batches[0]
    tx = optax.adam(1e-3, eps=1e-3)
    state = jax_state.create_train_state(
        model, tx, jax.random.PRNGKey(0), {}, {'x': x0}, jnp.asarray(m0))
    variables = randomized(jax.tree.map(np.asarray, dict(state.variables)),
                            1)
    state = state.replace(params=variables['params'],
                          batch_stats=variables['batch_stats'],
                          opt_state=tx.init(variables['params']))
  finally:
    jfb.set_enabled(None)

  def run(state=state):
    jfb.set_enabled(fused)
    try:
      step = jax.jit(jax_steps.make_train_step(
          jax_ops.make_loss_fn(loss_key)))
      metrics = []
      for x, labels, mask in batches:
        batch = jax_batch.RankingBatch(
            context={}, examples={'x': jnp.asarray(x)},
            labels=jnp.asarray(labels), mask=jnp.asarray(mask))
        state, m = step(state, batch, jax.random.PRNGKey(7))
        metrics.append({k: np.asarray(v) for k, v in m.items()})
      return metrics, jax.tree.map(np.asarray, {
          'params': state.params, 'batch_stats': state.batch_stats})
    finally:
      jfb.set_enabled(None)
  return variables, run


_METRICS = (('ndcg', 5), ('ndcg', None), ('mrr', None), ('precision', 3))


def _jax_eval(variables, batches):
  model = jax_scorers.RankingModel(
      scorer=jax_scorers.DNNScorer(hidden_layer_dims=HIDDEN, dropout=0.0,
                                   input_grad=False),
      transform_name='log1p')
  fns = {f'{k}@{t}': jax_metrics.make_ranking_metric_fn(k, topn=t)
         for k, t in _METRICS}
  step = jax.jit(jax_steps.make_eval_step(
      fns, loss_fn=jax_ops.make_loss_fn('softmax_loss')))
  state = jax_state.create_train_state(
      model, optax.adam(1e-3), jax.random.PRNGKey(0), {},
      {'x': batches[0][0]}, jnp.asarray(batches[0][2]))
  state = state.replace(params=variables['params'],
                        batch_stats=variables['batch_stats'])
  states = jax_steps.init_metric_states(fns, with_loss=True)
  for x, labels, mask in batches:
    batch = jax_batch.RankingBatch(context={}, examples={'x': jnp.asarray(x)},
                                   labels=jnp.asarray(labels),
                                   mask=jnp.asarray(mask))
    states, _ = step(state, batch, states)
  return {k: np.asarray(v)
          for k, v in jax_steps.metric_results(states).items()}


@pytest.fixture(scope='module')
def world_runs(tmp_path_factory):
  """The JAX references' weights, one spawn running every case at each
  world size, and the JAX steps while the ranks run (one after another:
  the fused switch is global)."""
  dnn_batches = _dnn_batches(2, 0)
  cases = (('dnn_fused', 'softmax_loss', True, 2),
           ('dnn_unfused', 'softmax_loss', False, 2),
           ('unique_softmax', 'unique_softmax_loss', True, 1))
  inits = {name: _jax_dnn(dnn_batches[:n], loss_key, fused)
           for name, loss_key, fused, n in cases}
  eval_batches = _dnn_batches(2, 5)
  x, labels, mask = eval_batches[1]
  eval_batches[1] = (x[:5], labels[:5], mask[:5])   # ragged: 5 lists
  eval_variables = inits['dnn_fused'][0]
  runs = {}
  for world in WORLDS:
    inputs = {}
    for name, loss_key, fused, n in cases:
      inputs[name] = (grid(world, False), {
          'state': dict(convert.from_flax(inits[name][0])),
          'batches': dnn_batches[:n], 'hidden': HIDDEN, 'features': F,
          'loss': loss_key, 'fused': fused})
    inputs['eval'] = (grid(world, False), {
        'state': dict(convert.from_flax(eval_variables)),
        'batches': eval_batches, 'hidden': HIDDEN, 'features': F,
        'metrics': _METRICS})
    runs[world] = (str(tmp_path_factory.mktemp(f'ranks{world}')), inputs)
  started = torch_dist_cases.start(runs)
  refs = {name: ((inits[name][0],) + inits[name][1](), dnn_batches[:n],
                 loss_key, fused) for name, loss_key, fused, n in cases}
  refs['eval'] = (_jax_eval(eval_variables, eval_batches), eval_batches)
  return refs, torch_dist_cases.join(started), None


# ------------------------------------------------------------------ tests


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('name', ['dnn_fused', 'dnn_unfused',
                                  'unique_softmax'])
def test_data_parallel_train_step_equals_jax_single_device(world_runs, world,
                                                          name):
  ((_, want_metrics, want), batches, _, _), runs = case(world_runs, world,
                                                         name)
  valid = [int(m[:B // 2].sum()) for _, _, m in batches] + [
      int(m[B // 2:].sum()) for _, _, m in batches]
  assert valid[0] != valid[len(batches)]   # unequal counts on the ranks
  for rank, res in enumerate(runs):
    for got_m, want_m in zip(res[name]['metrics'], want_metrics):
      for k in ('loss', 'labels_mean', 'logits_mean'):
        close(got_m[k], want_m[k], err_msg=f'rank {rank} {k}')
    tree = convert.to_flax({k: torch.from_numpy(v)
                            for k, v in res[name]['state'].items()})
    assert_tree_close(tree['params'], want['params'], atol=5e-6)
    assert_tree_close(tree['batch_stats'], want['batch_stats'], atol=1e-6)


@pytest.mark.parametrize('world', WORLDS)
def test_data_parallel_eval_metrics_equal_jax_single_device(world_runs,
                                                           world):
  (want, batches), runs = case(world_runs, world, 'eval')
  for res in runs:
    got = res['eval']['results']
    assert set(got) == set(want)
    for k in want:
      close(got[k], want[k], err_msg=k)
    # The logits returned are the global (padded) batch's.
    assert res['eval']['logits'][1].shape[0] >= batches[1][1].shape[0]
