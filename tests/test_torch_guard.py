"""The PyTorch port stands alone and runs on the card unless told not to.

It imports neither JAX, nor the JAX package, nor ``google.protobuf``, nor
TensorFlow: the card's machine has neither protobuf nor TensorFlow, so the
port reads and writes the wire format by hand (``data/proto.py``) and reads
TF checkpoints with its own reader (``models/bert_ckpt.py``).
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

from ranking_tpu_torch.data import dataset
from ranking_tpu_torch.data import trec
from ranking_tpu_torch.models import groupwise
from ranking_tpu_torch.models import layers
from ranking_tpu_torch.models import scorers
from ranking_tpu_torch.ops import aggregated
from ranking_tpu_torch.pipeline import export
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
             'data.native', 'data.libsvm', 'data.tfrecord', 'data.proto',
             'data.parsers', 'data.dataset', 'utils.tensorboard',
             'data.trec', 'ops.aggregated', 'pipeline.export',
             'ops.losses', 'ops.sorting', 'ops.loss_registry',
             'models.scorers', 'models.layers', 'models.groupwise',
             'utils.fns', 'utils.list_ops', 'train.sparse', 'train.state',
             'convert', 'train.steps', 'models.encoder', 'models.bert_ckpt',
             'data.bert', 'utils.profiling', 'parallel.mesh',
             'parallel.comm', 'parallel.embedding', 'parallel.list_sharding',
             'examples.ranking_elwc_pipeline', 'examples.ranking_libsvm',
             'examples.antique_din', 'examples.encoder_ranking',
             'examples.multitask_ranking', 'examples.serve_predict',
             'examples.trec_eval', 'examples.unbiased_two_tower'):
  assert 'ranking_tpu_torch.' + name in sys.modules, name
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',
                                    'tensorflow')
             or m == 'ranking_tpu' or m.startswith('ranking_tpu.')
             or m == 'google.protobuf' or m.startswith('google.protobuf.'))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
  repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  proc = subprocess.run([sys.executable, '-c', _CHECK], capture_output=True,
                        text=True, timeout=120, cwd=repo)
  assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_modules(path):
  with open(path) as f:
    tree = ast.parse(f.read(), path)
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      yield from (alias.name for alias in node.names)
    elif isinstance(node, ast.ImportFrom) and node.module:
      yield node.module
      yield from (f'{node.module}.{alias.name}' for alias in node.names)


def test_no_source_of_the_port_or_chip_smoke_imports_protobuf_or_jax():
  """Every import statement, also those inside functions that the runtime
  check above does not run (``chip_smoke.py`` runs only on the card)."""
  repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  paths = [os.path.join(repo, 'chip_smoke.py')]
  for root, _, names in os.walk(os.path.join(repo, 'ranking_tpu_torch')):
    paths += [os.path.join(root, n) for n in names if n.endswith('.py')]
  bad = []
  for path in paths:
    for name in _imported_modules(path):
      top = name.split('.')[0]
      if (top in ('jax', 'jaxlib', 'flax', 'optax', 'ranking_tpu',
                  'tensorflow')
          or name == 'google.protobuf'
          or name.startswith('google.protobuf.')):
        bad.append((os.path.relpath(path, repo), name))
  assert len(paths) > 40 and not bad, bad


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
  with pytest.raises(RuntimeError, match="device='cpu'"):
    steps.GraphedEvalStep(lambda *a, **k: None)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    trec.evaluate_run('unused', 'unused')
  with pytest.raises(RuntimeError, match="device='cpu'"):
    aggregated.PredictionAccumulator().compute({})
  with pytest.raises(RuntimeError, match="device='cpu'"):
    export.load_predictor('unused')
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


def test_the_other_scorers_and_the_dense_lazy_path_refuse_a_missing_card(
    monkeypatch):
  """GAM, groupwise, DIN and a Bilinear head build on the CPU, but their
  train state, like every entry point, asks for the card; so does the
  dense-gradient lazy path (a state with a ``sparse_tx`` under the plain
  train step)."""
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  models = [
      scorers.RankingModel(scorers.GAMScorer((4,), {'x': 1})),
      scorers.RankingModel(groupwise.GroupwiseDNNScorer(6, group_size=2)),
      scorers.RankingModel(scorers.DINScorer(3, head_size=4,
                                             hidden_layer_dims=(4,))),
      layers.Bilinear(3, 2)]
  for model in models:
    with pytest.raises(RuntimeError, match="device='cpu'"):
      state_lib.create_train_state(model)
    state_lib.create_train_state(model, device='cpu')
  embedding_model = scorers.RankingModel(
      scorers.EmbeddingDNNScorer((4,), {'q': 10}, embedding_dim=2))
  with pytest.raises(RuntimeError, match="device='cpu'"):
    state_lib.create_train_state(embedding_model,
                                 sparse_tx=sparse.LazyAdam(max_rows=4))
  with pytest.raises(RuntimeError, match="device='cpu'"):
    steps.make_train_step(lambda *a, **k: None)
  state = state_lib.create_train_state(
      embedding_model, device='cpu', sparse_tx=sparse.LazyAdagrad(max_rows=4))
  assert state.sparse_opt_state['dropped'].device == torch.device('cpu')


def test_distribution_refuses_a_missing_card(monkeypatch):
  """A rank asks for the card unless told ``device='cpu'``: the process
  group's bring-up and the CLI raise before any group exists."""
  from ranking_tpu_torch import parallel
  from ranking_tpu_torch.examples import ranking_elwc_pipeline as cli
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    parallel.init_distributed()
  with pytest.raises(RuntimeError, match="device='cpu'"):
    cli.main(['--train_pattern=unused', '--valid_pattern=unused'])
  assert not torch.distributed.is_initialized()


@pytest.mark.parametrize('name, argv', [
    ('trec_eval', ['--qrels=q', '--run=r']),
    ('ranking_libsvm', ['--train_path=t', '--vali_path=v']),
    ('unbiased_two_tower', []),
    ('serve_predict', ['--export_path=e', '--input=i']),
    ('multitask_ranking', ['--train_pattern=t', '--valid_pattern=v']),
    ('antique_din', ['--train_pattern=t', '--valid_pattern=v']),
    ('encoder_ranking', ['--train_pattern=t', '--valid_pattern=v']),
    ('ranking_elwc_pipeline', ['--train_pattern=t', '--valid_pattern=v'])])
def test_example_programs_refuse_a_missing_card(monkeypatch, name, argv):
  """Each program runs on the card by default (``--device=cuda``) and
  raises, before it reads a file, where there is none."""
  import importlib
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  cli = importlib.import_module(f'ranking_tpu_torch.examples.{name}')
  with pytest.raises(RuntimeError, match="device='cpu'"):
    cli.main(argv)

