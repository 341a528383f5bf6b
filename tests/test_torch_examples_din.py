"""The port's ``antique_din`` and ``ranking_elwc_pipeline`` CLIs against the
JAX CLIs, on the CPU, over ELWC files that the test writes with the port's
encoder.

Each JAX CLI runs its ``main`` with its pipeline recorded instead of trained
(``torch_cli_cases.record_jax_pipelines``), which gives the model and the
dataset builder that the CLI made. Its specs and the port CLI's parse the
validation file to equal arrays; its model, initialized and randomized,
loads strictly into the port CLI's model (``convert.from_flax``, and back
with ``to_flax``), and the eval-mode forwards agree at 1e-5. Both CLIs hard-code
dropout (0.5), and JAX and torch draw different masks, so no train step
can match across the packages: the port CLI's ``main`` runs a short
training and prints ``final:``.
"""

import os

import numpy as np
import pytest
import torch

from ranking_tpu_torch.data import tfrecord
from ranking_tpu_torch.examples import antique_din as din_cli
from ranking_tpu_torch.examples import ranking_elwc_pipeline as elwc_cli

import test_torch_elwc_cli
import torch_cli_cases

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

BUCKETS, LIST = 100, 6


@pytest.fixture(scope='module')
def files(tmp_path_factory):
  d = tmp_path_factory.mktemp('din_cli')
  test_torch_elwc_cli._write(str(d / 'train.tfrecord'), 16, 0)
  test_torch_elwc_cli._write(str(d / 'valid.tfrecord'), 6, 1)
  return d


def _argv(files, model_dir, extra=()):
  return [f'--train_pattern={files / "train.tfrecord"}',
          f'--valid_pattern={files / "valid.tfrecord"}',
          f'--model_dir={model_dir}', '--batch_size=4',
          f'--list_size={LIST}', f'--hash_buckets={BUCKETS}',
          '--embedding_dim=4', '--num_epochs=1', '--steps_per_epoch=2',
          '--validation_steps=1', *extra]


def _hold(monkeypatch, files, tmp_path, name, argv, port_model):
  made = torch_cli_cases.record_jax_pipelines(monkeypatch)
  torch_cli_cases.run_jax_cli(monkeypatch, name, argv)
  assert len(made) == 1
  jpipe = made[0]
  records = tfrecord.read_all_records(str(files / 'valid.tfrecord'))
  return jpipe, torch_cli_cases.parsed_equal(
      jpipe.dataset_builder, port_model[1], records, LIST), port_model[0]


@pytest.mark.parametrize('dasalc', [False, True], ids=['din', 'dasalc'])
def test_din_cli_holds_the_jax_cli(files, tmp_path, monkeypatch, capsys,
                                   dasalc):
  argv = _argv(files, tmp_path / 'run', ['--head_size=8',
                                        '--hidden_layer_dims=8,4']
               + (['--dasalc'] if dasalc else []))
  pipe, history = din_cli.main(argv + ['--device=cpu'])
  out = capsys.readouterr().out
  assert 'final:' in out and np.isfinite(history['loss'])
  args = din_cli.parse_args(argv)
  model = din_cli._din_with_embeddings(args, args.hash_buckets)
  attention = model.scorer.din.attention
  assert len(attention.attentions) == (4 if dasalc else 1)
  jpipe, parsed, model = _hold(monkeypatch, files, tmp_path, 'antique_din',
                               argv, (model, pipe.dataset_builder))
  torch_cli_cases.hold_eval_forward(
      jpipe.model, model, parsed.context, parsed.examples, parsed.mask)


def test_elwc_cli_holds_the_jax_cli(files, tmp_path, monkeypatch, capsys):
  """The ELWC CLI of the distribution slice, which its own test runs on the
  port alone."""
  argv = _argv(files, tmp_path / 'run', [
      '--query_tokens=3', '--document_tokens=5', '--hidden_layer_dims=8,4',
      '--loss=softmax_loss'])
  pipe, _ = elwc_cli.main(argv + ['--device=cpu'])
  capsys.readouterr()
  jpipe, parsed, model = _hold(monkeypatch, files, tmp_path,
                               'ranking_elwc_pipeline', argv,
                               (pipe.model.cpu(), pipe.dataset_builder))
  assert jpipe.hparams.optimizer == pipe.hparams.optimizer
  assert jpipe.hparams.best_exporter_metric == pipe.hparams.best_exporter_metric
  # The label is not a model input: the pipelines pop it from the batch.
  examples = {k: v for k, v in parsed.examples.items() if k != 'relevance'}
  torch_cli_cases.hold_eval_forward(
      jpipe.model, model, parsed.context, examples, parsed.mask)
