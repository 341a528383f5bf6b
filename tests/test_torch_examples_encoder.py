"""The port's ``encoder_ranking`` CLI against the JAX CLI, on the CPU, over
ELWC files of hashed query and document tokens that the test writes.

The JAX CLI runs its ``main`` with its pipeline recorded instead of trained
(``torch_cli_cases.record_jax_pipelines``), which gives its
``BertInputBuilder`` and model. The port's builder fuses ``[CLS] q [SEP] d
[SEP]`` ids equal to the JAX builder's over the whole validation stream;
the JAX model, randomized, loads strictly into the port CLI's model with
the eval-mode forward at 1e-5; and ``--warm_start_dir`` overlays an export
bitwise: the port CLI's model equals the port export it is given, and the
state that the JAX CLI's wrapped ``_build`` makes from an Orbax export of
the same values. The CLI hard-codes dropout 0.1, so the port CLI's
``main`` runs a short training of its own (with ``--remat``) and prints
``final:``. ``test_torch_examples_bert.py`` has the ``--init_checkpoint``
mode.
"""

import os

import jax
import numpy as np
import torch

from ranking_tpu_torch import convert
from ranking_tpu_torch.examples import encoder_ranking as cli
from ranking_tpu_torch.train import checkpoint
from ranking_tpu_torch.train import state as state_lib

import test_torch_elwc_cli
import torch_cli_cases

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

LIST = 5


def _argv(tmp_path, extra=()):
  return [f'--train_pattern={tmp_path / "train.tfrecord"}',
          f'--valid_pattern={tmp_path / "valid.tfrecord"}',
          f'--model_dir={tmp_path / "run"}', '--batch_size=2',
          f'--list_size={LIST}', '--seq_len=12', '--vocab_buckets=50',
          '--hidden_dim=8', '--num_layers=2', '--num_heads=2',
          '--num_epochs=1', '--steps_per_epoch=2', '--validation_steps=2',
          *extra]


def test_encoder_cli_holds_the_jax_cli(tmp_path, monkeypatch, capsys):
  from ranking_tpu.train import checkpoint as jax_checkpoint
  test_torch_elwc_cli._write(str(tmp_path / 'train.tfrecord'), 8, 0)
  test_torch_elwc_cli._write(str(tmp_path / 'valid.tfrecord'), 5, 1)
  argv = _argv(tmp_path)

  pipe, history = cli.main(argv + ['--remat', '--device=cpu'])
  assert 'final:' in capsys.readouterr().out
  assert np.isfinite(history['loss'])

  made = torch_cli_cases.record_jax_pipelines(monkeypatch)
  torch_cli_cases.run_jax_cli(monkeypatch, 'encoder_ranking', argv)
  jpipe = made[0]
  jbatches = list(jpipe.dataset_builder.valid_batches())
  batches = list(pipe.dataset_builder.valid_batches())
  assert len(batches) == len(jbatches) == 3
  for got, want in zip(batches, jbatches):
    assert list(got.examples) == list(want.examples) == ['input_ids']
    ids = got.examples['input_ids'].numpy()
    assert ids.dtype == np.int32
    np.testing.assert_array_equal(ids, np.asarray(want.examples['input_ids']))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))

  args = cli.parse_args(argv)
  model, seq_len = cli.build_model(args)
  assert seq_len == 12
  sample = jbatches[0]
  variables = torch_cli_cases.hold_eval_forward(
      jpipe.model, model, {}, {'input_ids': np.asarray(
          sample.examples['input_ids'])}, np.asarray(sample.mask))

  # --warm_start_dir: the port's export of these values, and JAX's.
  checkpoint.export_params(state_lib.create_train_state(model, device='cpu'),
                           str(tmp_path / 'port_export'))
  jax_checkpoint.export_params(
      type('State', (), {'params': variables['params'], 'batch_stats': {}}),
      str(tmp_path / 'jax_export'))
  started, _ = cli.build_model(cli.parse_args(
      argv + [f'--warm_start_dir={tmp_path / "port_export"}']),
                               torch.Generator().manual_seed(5))
  export = checkpoint.load_params(str(tmp_path / 'port_export'))
  assert sorted(started.state_dict()) == sorted(export)
  for k, v in started.state_dict().items():
    assert torch.equal(v, export[k]), k
  made.clear()
  torch_cli_cases.run_jax_cli(
      monkeypatch, 'encoder_ranking',
      argv + [f'--warm_start_dir={tmp_path / "jax_export"}'])
  jstate = made[0]._build(sample)
  jax.tree_util.tree_map(
      np.testing.assert_array_equal,
      convert.to_flax(started.state_dict())['params'],
      jax.tree_util.tree_map(np.asarray, jstate.params))
