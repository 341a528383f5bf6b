"""The PyTorch port stands alone and runs on the card unless told not to."""

import os
import subprocess
import sys

import pytest
import torch

from ranking_tpu_torch.data import dataset
from ranking_tpu_torch.models import scorers
from ranking_tpu_torch.pipeline import hparams as hparams_lib
from ranking_tpu_torch.pipeline import pipeline
from ranking_tpu_torch.pipeline import serving
from ranking_tpu_torch.train import sparse
from ranking_tpu_torch.train import state as state_lib
from ranking_tpu_torch.train import steps

_CHECK = """
import pkgutil, sys, importlib
import ranking_tpu_torch
for mod in pkgutil.walk_packages(ranking_tpu_torch.__path__,
                                 'ranking_tpu_torch.'):
  importlib.import_module(mod.name)
for name in ('pipeline.pipeline', 'pipeline.hparams', 'train.checkpoint',
             'data.native', 'data.libsvm', 'data.tfrecord',
             'utils.tensorboard'):
  assert 'ranking_tpu_torch.' + name in sys.modules, name
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax')
             or m == 'ranking_tpu' or m.startswith('ranking_tpu.'))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
  repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  proc = subprocess.run([sys.executable, '-c', _CHECK], capture_output=True,
                        text=True, timeout=120, cwd=repo)
  assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_refuse_a_missing_card(monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  model = scorers.RankingModel(scorers.DNNScorer((4,), in_features=3))
  with pytest.raises(RuntimeError, match="device='cpu'"):
    serving.Predictor(model)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    serving.evaluate_dataset(model, None, [])
  with pytest.raises(RuntimeError, match="device='cpu'"):
    steps.make_eval_step({})
  with pytest.raises(RuntimeError, match="device='cpu'"):
    steps.make_train_step(lambda *a, **k: None)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    state_lib.create_train_state(model)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    steps.init_metric_states({})
  embedding_model = scorers.RankingModel(
      scorers.EmbeddingDNNScorer((4,), {'q': 10}, embedding_dim=2))
  with pytest.raises(RuntimeError, match="device='cpu'"):
    steps.make_sparse_train_step(lambda *a, **k: None, ())
  with pytest.raises(RuntimeError, match="device='cpu'"):
    state_lib.create_train_state(embedding_model,
                                 sparse_tx=sparse.LazyAdam())
  with pytest.raises(RuntimeError, match="device='cpu'"):
    steps.make_multi_step(lambda *a, **k: None)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    dataset.prefetch_to_device([])
  hparams = hparams_lib.PipelineHparams(
      model_dir='unused', num_epochs=1, steps_per_epoch=1,
      validation_steps=1, learning_rate=0.1, loss='softmax_loss')
  with pytest.raises(RuntimeError, match="device='cpu'"):
    pipeline.SimplePipeline(model, None, hparams)
  serving.Predictor(model, device='cpu')  # the CPU when asked
  steps.make_multi_step(lambda *a, **k: None, device='cpu')
  pipeline.SimplePipeline(model, None, hparams, device='cpu')
  state_lib.create_train_state(model, device='cpu')
  steps.make_train_step(lambda *a, **k: None, device='cpu')
  steps.make_sparse_train_step(lambda *a, **k: None, (), device='cpu')
  state = state_lib.create_train_state(embedding_model, device='cpu',
                                       sparse_tx=sparse.LazyAdam())
  assert state.sparse_opt_state['scorer/embed_q/embedding']['m'].device == (
      torch.device('cpu'))
