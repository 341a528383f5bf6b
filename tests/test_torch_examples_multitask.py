"""The port's ``multitask_ranking`` CLI against the JAX CLI, on the CPU.

``add_click_labels`` of both CLIs copies one ELWC file (written by the
port's encoder; documents without a relevance feature and with relevance
0-2) adding clicks from the same seed: the port's parser reads the two
copies to equal arrays. The JAX CLI runs its ``main`` with its pipeline
recorded instead of trained (``torch_cli_cases.record_jax_pipelines``); its
specs and the port CLI's parse the two-label validation file to equal
arrays, and its ``MultiTaskScorer`` model, randomized, loads strictly into
the port CLI's, with the eval-mode forward of both heads at 1e-5. The CLI
hard-codes dropout 0.3, which JAX and torch draw differently, so the port
CLI's ``main`` runs a short training of its own and prints the
``relevance/ndcg@5`` metric.
"""

import os

import numpy as np
import pytest
import torch

from ranking_tpu_torch.data import parsers
from ranking_tpu_torch.data import proto
from ranking_tpu_torch.data import tfrecord
from ranking_tpu_torch.examples import multitask_ranking as cli

import torch_cli_cases

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

BUCKETS, LIST = 100, 6


def _write(path, num_lists, seed):
  rng = np.random.RandomState(seed)
  words = [f'w{i}'.encode() for i in range(300)]
  records = []
  for _ in range(num_lists):
    docs = []
    for _ in range(rng.randint(2, 7)):
      doc = {'document_tokens': [words[i] for i in
                                 rng.randint(0, 300, rng.randint(1, 6))]}
      if rng.rand() < 0.85:
        doc['relevance'] = [int(rng.randint(0, 3))]
      docs.append(doc)
    records.append(proto.make_elwc(
        {'query_tokens': [words[i] for i in rng.randint(0, 300, 3)]}, docs))
  tfrecord.write_records(path, records)


def test_multitask_cli_holds_the_jax_cli(tmp_path, monkeypatch, capsys):
  _write(str(tmp_path / 'train.tfrecord'), 16, 0)
  _write(str(tmp_path / 'valid.tfrecord'), 6, 1)
  argv = [f'--train_pattern={tmp_path / "train.tfrecord"}',
          f'--valid_pattern={tmp_path / "valid.tfrecord"}',
          '--batch_size=4', f'--list_size={LIST}',
          f'--hash_buckets={BUCKETS}', '--embedding_dim=4',
          '--hidden_layer_dims=8,4', '--num_epochs=1',
          '--steps_per_epoch=2', '--validation_steps=1']
  made = torch_cli_cases.record_jax_pipelines(monkeypatch,
                                              'MultiTaskPipeline')
  torch_cli_cases.run_jax_cli(monkeypatch, 'multitask_ranking',
                              argv + [f'--model_dir={tmp_path / "jax"}'])
  pipe, history = cli.main(argv + [f'--model_dir={tmp_path / "port"}',
                                   '--device=cpu'])
  out = capsys.readouterr().out
  assert 'relevance/ndcg@5' in out and 'final:' in out
  assert np.isfinite(history['loss'])

  # The two copies with clicks read alike.
  spec = dict(pipe.dataset_builder.example_feature_spec)
  for name in ('train', 'valid'):
    copies = [tfrecord.read_all_records(
        str(tmp_path / who / f'{name}_2label.tfrecord'))
              for who in ('jax', 'port')]
    assert len(copies[0]) == len(copies[1])
    want, got = (parsers.parse_example_list(
        records, pipe.dataset_builder.context_feature_spec, spec, LIST)
                 for records in copies)
    assert want.examples['click'].sum() > 0
    for part in ('context', 'examples'):
      for k, v in getattr(want, part).items():
        np.testing.assert_array_equal(getattr(got, part)[k], v, err_msg=k)
    np.testing.assert_array_equal(got.mask, want.mask)

  assert len(made) == 1
  jpipe = made[0]
  records = tfrecord.read_all_records(
      str(tmp_path / 'port' / 'valid_2label.tfrecord'))
  parsed = torch_cli_cases.parsed_equal(jpipe.dataset_builder,
                                        pipe.dataset_builder, records, LIST)
  examples = {k: v for k, v in parsed.examples.items()
              if k not in ('relevance', 'click')}
  model = cli.build_model(cli.parse_args(argv))
  torch_cli_cases.hold_eval_forward(jpipe.model, model, parsed.context,
                                    examples, parsed.mask)


def test_add_click_labels_raises_on_a_pattern_that_matches_nothing(tmp_path):
  with pytest.raises(FileNotFoundError, match='nothing-here'):
    cli.add_click_labels(str(tmp_path / 'nothing-here*.tfrecord'),
                         str(tmp_path / 'out.tfrecord'))
  assert not os.path.exists(tmp_path / 'out.tfrecord')
