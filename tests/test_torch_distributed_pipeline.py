"""The port's pipeline over a mesh of gloo ranks on the CPU == the one-card
pipeline, and its checkpoints move between the two.

One ``torch.multiprocessing`` spawn runs world 2 (``model=2``), world 4
(``data=2 x model=2``) and world 3 at once (``tests/torch_dist_cases.py``):

* a 2-epoch pipeline over the hparams' mesh, whose export equals the
  one-card pipeline's, whose checkpoint restores on one card, and which
  restores a one-card checkpoint;
* the pipeline over the encoder under ``ENCODER_TP_RULES``;
* three ranks for a batch of 4, where the data axis takes two.

Tolerance: the export at rtol 1e-4 atol 1e-6 after 6 Adam steps (rounding
differences that Adam's normalisation carries into the updates, as
``tests/test_torch_distributed_sharded.py`` derives its own). Exports and
checkpoints of one run are equal bitwise.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from ranking_tpu_torch.pipeline import hparams as hparams_lib
from ranking_tpu_torch.pipeline import pipeline
from ranking_tpu_torch.train import checkpoint
from ranking_tpu_torch.train import state as state_lib

import torch_dist_cases
from torch_dist_refs import WORLDS, close, grid

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)


PIPE = dict(vocab=64, hidden=(8,), dim=4, batch=4, n_valid=9)


def _pipeline_arrays():
  rng = np.random.RandomState(4)
  n, l, t = 24, 5, 3
  labels = rng.randint(0, 3, size=(n, l)).astype(np.float32)
  labels[rng.rand(n, l) < 0.2] = -1.0
  labels[:, 0] = np.maximum(labels[:, 0], 0.0)
  q = rng.randint(-1, PIPE['vocab'], size=(n, t)).astype(np.int64)
  d = rng.randint(-1, PIPE['vocab'], size=(n, l, t)).astype(np.int64)
  return q, d, labels


@pytest.fixture(scope='module')
def world_runs(tmp_path_factory):
  """The one-card pipeline, whose checkpoint the ranks resume from, then
  one spawn running every case at each world size."""
  base = tmp_path_factory.mktemp('pipeline')
  arrays = _pipeline_arrays()
  one = pipeline.SimplePipeline(
      torch_dist_cases.pipeline_model(PIPE['vocab'], PIPE['hidden'],
                                      PIPE['dim']),
      torch_dist_cases.TokenBuilder(arrays, PIPE['batch'], PIPE['n_valid']),
      torch_dist_cases.pipeline_hparams(str(base / 'one')), device='cpu')
  one.train_and_validate()

  runs = {}
  for world in WORLDS:
    resume_dir = str(base / f'resume{world}')
    shutil.copytree(str(base / 'one'), resume_dir)
    runs[world] = (str(tmp_path_factory.mktemp(f'ranks{world}')), {
        'pipeline': (grid(world, True), {
            'config': PIPE, 'arrays': arrays,
            'model_dir': str(base / f'world{world}'),
            'resume_dir': resume_dir}),
        'pipeline_tp': (grid(world, True), {
            'config': PIPE, 'arrays': arrays,
            'model_dir': str(base / f'tp{world}')})})
  # Three ranks for a batch of 4: a data axis of 2, one rank idle.
  runs[3] = (str(tmp_path_factory.mktemp('ranks3')), {'pipeline_idle': (
      (None, None), {'config': PIPE, 'arrays': arrays,
                     'model_dir': str(base / 'idle')})})
  return None, torch_dist_cases.spawn(runs), base


# ------------------------------------------------------------------ tests


@pytest.mark.parametrize('world', WORLDS)
def test_pipeline_over_the_mesh_equals_one_card_and_checkpoints_move(
    world_runs, world):
  _, runs, base = world_runs
  for rank, r in enumerate(runs[world]):
    assert 'error' not in r['pipeline'], r['pipeline'].get('error')
  data, model = grid(world, True)
  res = runs[world][0]['pipeline']
  assert res['mesh'] == (data, model)
  assert set(res['local_rows'].values()) == {PIPE['vocab'] // model}
  assert res['resumed_step'] == 6
  run_dir, one_dir = base / f'world{world}', base / 'one'
  # One writer: a line an epoch in the event log.
  with open(run_dir / 'metrics.jsonl') as f:
    assert len(f.read().splitlines()) == 2
  got = checkpoint.load_params(str(run_dir / 'export' / 'latest'))
  want = checkpoint.load_params(str(one_dir / 'export' / 'latest'))
  assert set(got) == set(want)
  for k in want:
    assert got[k].shape == want[k].shape, k
    close(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
  # The mesh's checkpoint restores on one card, bitwise its export.
  hp = torch_dist_cases.pipeline_hparams('unused')
  state = state_lib.create_train_state(
      torch_dist_cases.pipeline_model(PIPE['vocab'], PIPE['hidden'],
                                      PIPE['dim']),
      hparams_lib.optimizer_from_hparams(hp), device='cpu',
      sparse_tx=hparams_lib.sparse_optimizer_from_hparams(hp))
  ckpt = checkpoint.CheckpointManager(str(run_dir / 'checkpoints'))
  ckpt.restore(state)
  assert state.step == 6
  for k, v in state.model.state_dict().items():
    assert torch.equal(v, got[k]), k
  # The one-card checkpoint restored on the mesh exports it bitwise.
  resumed = checkpoint.load_params(str(base / f'resume{world}' / 'export' /
                                       'latest'))
  for k in want:
    assert torch.equal(resumed[k], want[k]), k


@pytest.mark.parametrize('world', WORLDS)
def test_pipeline_trains_the_encoder_tensor_parallel(world_runs, world):
  """``SimplePipeline(sharding_rules=ENCODER_TP_RULES)`` trains data x
  tensor parallel (``tests/test_pipeline.py:721-733``): finite metrics, the
  projections split over the model axis, and an export of whole
  parameters."""
  _, runs, base = world_runs
  for rank, r in enumerate(runs[world]):
    assert 'error' not in r['pipeline_tp'], r['pipeline_tp'].get('error')
    assert np.isfinite(r['pipeline_tp']['history']['loss'])
    assert ('scorer.encoder.block_0.MultiHeadDotProductAttention_0.query.'
            'kernel') in r['pipeline_tp']['sharded']
  export = checkpoint.load_params(str(base / f'tp{world}' / 'export' /
                                      'latest'))
  kernel = export['scorer.encoder.block_0.MultiHeadDotProductAttention_0.'
                  'query.kernel']
  assert tuple(kernel.shape) == (8, 2, 4)


def test_pipeline_leaves_the_ranks_past_the_data_axis_idle(world_runs):
  """Three ranks, a global batch of 4: the data axis takes 2 of them (the
  JAX package's largest divisor, with its warning) and the third idles;
  the two train as one card would (their export, the one card's)."""
  _, runs, base = world_runs
  res = [r['pipeline_idle'] for r in runs[3]]
  for r in res:
    assert 'error' not in r, r.get('error')
  assert [r['member'] for r in res] == [True, True, False]
  assert all(r['mesh'] == (2, 1) and r['warned'] for r in res)
  assert res[2]['history'] == {} and np.isfinite(res[0]['history']['loss'])
  got = checkpoint.load_params(str(base / 'idle' / 'export' / 'latest'))
  want = checkpoint.load_params(str(base / 'one' / 'export' / 'latest'))
  for k in want:
    close(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
