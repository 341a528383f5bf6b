"""The port's ``encoder_ranking`` CLI in its pretrained-BERT mode against the
JAX CLI, on the CPU.

The test writes a tiny TF2 BERT checkpoint (``test_torch_bert._write_bert``,
with TensorFlow's own writer) and ELWC records in the TFRBertDataLoader
format (``input_ids`` / ``input_mask`` / ``segment_ids``), and raw
``query`` / ``document`` strings with a WordPiece vocabulary. The JAX CLI
runs its ``main`` with its pipeline recorded instead of trained
(``torch_cli_cases.record_jax_pipelines``). With ``--init_checkpoint`` the
port CLI's model holds the checkpoint's encoder bitwise as the state that
the JAX CLI's wrapped ``_build`` makes; with ``--vocab_file`` the port's
``TokenizingBuilder`` gives the JAX one's batches, bitwise; and the port
CLI's ``main`` trains a few steps from the checkpoint and prints
``final:``. TensorFlow's import is most of this file's time.
"""

import os

import jax
import numpy as np
import pytest
import torch

from ranking_tpu_torch import convert
from ranking_tpu_torch.data import proto
from ranking_tpu_torch.data import tfrecord
from ranking_tpu_torch.examples import encoder_ranking as cli

import test_torch_bert
import torch_cli_cases

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

LIST, SEQ = 4, 12
WORDS = ['the', 'cat', 'sat', 'on', 'mat', 'dog', 'ran', '##s', 'far']


def _write_ids(path, num_lists, seed):
  rng = np.random.RandomState(seed)
  records = []
  for _ in range(num_lists):
    docs = []
    for _ in range(rng.randint(1, LIST + 2)):
      n = rng.randint(3, SEQ + 1)
      docs.append({
          'input_ids': np.r_[rng.randint(1, 30, n), np.zeros(SEQ - n, int)],
          'input_mask': np.r_[np.ones(n, int), np.zeros(SEQ - n, int)],
          'segment_ids': np.r_[np.zeros(n // 2, int),
                               np.ones(SEQ - n // 2, int)],
          'relevance': [int(rng.randint(0, 3))]})
    records.append(proto.make_elwc({}, docs))
  tfrecord.write_records(path, records)


def _write_text(path, num_lists, seed):
  rng = np.random.RandomState(seed)
  records = []
  for _ in range(num_lists):
    query = ' '.join(rng.choice(WORDS[:7], 2))
    docs = [{'query': [query.encode()],
             'document': [' '.join(rng.choice(WORDS[:7] + ['cats', 'far'],
                                              rng.randint(1, 6))).encode()],
             'relevance': [int(rng.randint(0, 3))]}
            for _ in range(rng.randint(1, LIST + 2))]
    records.append(proto.make_elwc({}, docs))
  tfrecord.write_records(path, records)


def _argv(tmp_path, data, extra):
  return [f'--train_pattern={tmp_path / data}_train.tfrecord',
          f'--valid_pattern={tmp_path / data}_valid.tfrecord',
          f'--model_dir={tmp_path / data}_run', '--batch_size=2',
          f'--list_size={LIST}', f'--seq_len={SEQ + 4}', '--num_epochs=1',
          '--steps_per_epoch=2', '--validation_steps=1', *extra]


def test_bert_modes_hold_the_jax_cli(tmp_path, monkeypatch, capsys):
  tf = pytest.importorskip('tensorflow')
  variables = test_torch_bert._bert_variables(test_torch_bert.CFG,
                                              np.random.RandomState(3))
  ckpt, config = test_torch_bert._write_bert(tf, str(tmp_path / 'bert'),
                                             variables)
  vocab = tmp_path / 'vocab.txt'
  vocab.write_text('\n'.join(['[PAD]', '[UNK]', '[CLS]', '[SEP]'] + WORDS)
                   + '\n')
  for split, seed in (('train', 0), ('valid', 1)):
    _write_ids(str(tmp_path / f'ids_{split}.tfrecord'), 6, seed)
    _write_text(str(tmp_path / f'text_{split}.tfrecord'), 6, seed + 2)
  bert = [f'--init_checkpoint={ckpt}', f'--bert_config={config}']

  made = torch_cli_cases.record_jax_pipelines(monkeypatch)
  # --init_checkpoint: the checkpoint's encoder in both.
  argv = _argv(tmp_path, 'ids', bert)
  torch_cli_cases.run_jax_cli(monkeypatch, 'encoder_ranking', argv)
  sample = next(iter(made[0].dataset_builder.valid_batches()))
  jstate = made[0]._build(sample)
  model, seq_len = cli.build_model(cli.parse_args(argv))
  assert seq_len == SEQ       # the checkpoint's max_position_embeddings
  jax.tree_util.tree_map(
      np.testing.assert_array_equal,
      convert.to_flax(model.state_dict())['params']['scorer']['encoder'],
      jax.tree_util.tree_map(np.asarray,
                             jstate.params['scorer']['encoder']))
  pipe, history = cli.main(argv + ['--device=cpu'])
  assert 'final:' in capsys.readouterr().out
  assert np.isfinite(history['loss'])

  # --vocab_file: the same tokenized batches.
  argv = _argv(tmp_path, 'text', bert + [f'--vocab_file={vocab}'])
  made.clear()
  torch_cli_cases.run_jax_cli(monkeypatch, 'encoder_ranking', argv)
  args = cli.parse_args(argv)
  builder = cli.build_dataset(args, cli.build_model(args)[1])
  jbuilder = made[0].dataset_builder
  for got_stream, want_stream in ((builder.valid_batches(),
                                   jbuilder.valid_batches()),
                                  (builder.train_batches(),
                                   jbuilder.train_batches())):
    pairs = list(zip(range(4), got_stream, want_stream))
    assert len(pairs) >= 3
    for _, got, want in pairs:
      assert sorted(got.examples) == sorted(want.examples)
      for k in want.examples:
        np.testing.assert_array_equal(got.examples[k].numpy(),
                                      np.asarray(want.examples[k]))
      np.testing.assert_array_equal(got.labels.numpy(), want.labels)
      np.testing.assert_array_equal(got.mask.numpy(), want.mask)
