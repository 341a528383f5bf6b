"""The port's ELWC pipeline CLI (``ranking_tpu_torch/examples/
ranking_elwc_pipeline.py``) on the CPU, at tiny widths: once on one rank in
this process, once on two gloo ranks with ``--mesh_model=2`` (one
``torch.multiprocessing`` spawn, a ``file://`` rendezvous under the test's
directory), over ELWC files that the test writes with the port's own
encoder (``data/proto.py``, ``data/tfrecord.py``).

The two-rank run writes one set of checkpoints and one export (the first
rank's); its checkpoint restores into the one-card model, bitwise its
export; and the export, served by the one-card model, scores the first
validation batch as the live sharded model does, to rtol 1e-6 (the pooled
lookup sums its partial sums over the shards in another order).
"""

import os

import numpy as np
import pytest
import torch

from ranking_tpu_torch.data import proto
from ranking_tpu_torch.data import tfrecord
from ranking_tpu_torch.examples import ranking_elwc_pipeline as cli
from ranking_tpu_torch.models import scorers
from ranking_tpu_torch.pipeline import hparams as hparams_lib
from ranking_tpu_torch.train import checkpoint
from ranking_tpu_torch.train import state as state_lib

import torch_dist_cases

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

BUCKETS, DIM, HIDDEN = 100, 4, '8,4'


def _write(path, num_lists, seed):
  rng = np.random.RandomState(seed)
  words = [f'w{i}'.encode() for i in range(300)]

  def tokens(n):
    return [words[i] for i in rng.randint(0, len(words), size=n)]

  records = []
  for _ in range(num_lists):
    docs = [{'document_tokens': tokens(rng.randint(1, 6)),
             'relevance': [int(rng.randint(0, 3))]}
            for _ in range(rng.randint(2, 7))]
    records.append(proto.make_elwc({'query_tokens': tokens(3)}, docs))
  tfrecord.write_records(path, records)


@pytest.fixture(scope='module')
def files(tmp_path_factory):
  d = tmp_path_factory.mktemp('elwc_cli')
  _write(str(d / 'train.tfrecord'), 24, 0)
  _write(str(d / 'valid.tfrecord'), 9, 1)
  return d


def _argv(files, model_dir, extra=()):
  return [f'--train_pattern={files / "train.tfrecord"}',
          f'--valid_pattern={files / "valid.tfrecord"}',
          f'--model_dir={model_dir}', '--batch_size=4', '--list_size=6',
          '--query_tokens=3', '--document_tokens=5',
          f'--hash_buckets={BUCKETS}', f'--embedding_dim={DIM}',
          f'--hidden_layer_dims={HIDDEN}', '--num_epochs=2',
          '--steps_per_epoch=2', '--validation_steps=2',
          '--loss=softmax_loss', '--device=cpu', *extra]


def _one_card_state():
  model = scorers.RankingModel(scorers.EmbeddingDNNScorer(
      (8, 4), vocab_sizes={'query_tokens': BUCKETS,
                           'document_tokens': BUCKETS},
      embedding_dim=DIM, dropout=0.5))
  hp = hparams_lib.PipelineHparams(
      model_dir='unused', num_epochs=1, steps_per_epoch=1,
      validation_steps=1, learning_rate=0.05, loss='softmax_loss')
  return state_lib.create_train_state(
      model, hparams_lib.optimizer_from_hparams(hp), device='cpu')


def test_cli_on_one_rank(files, tmp_path):
  """With ``--weights_feature`` (absent from the files: every weight its
  default 1.0), which reaches the loss and not the scorer."""
  pipe, history = cli.main(_argv(files, tmp_path / 'run',
                                 ['--weights_feature=ipw']))
  assert pipe.mesh is None
  assert pipe.hparams.weights_feature_name == 'ipw'
  assert pipe.model.scorer.drop == 'ipw'
  assert np.isfinite(history['loss']) and 'ndcg@5' in history
  assert (tmp_path / 'run' / 'export' / 'latest' / 'params.pt').exists()
  assert (tmp_path / 'run' / 'export' / 'best' / 'params.pt').exists()


def test_cli_on_two_ranks_with_mesh_model(files, tmp_path):
  run_dir = tmp_path / 'run'
  ranks = torch_dist_cases.spawn_cli(
      str(tmp_path / 'ranks'), 2, _argv(files, run_dir, ['--mesh_model=2']))
  assert [r['mesh'] for r in ranks] == [(1, 2), (1, 2)]
  metrics = [{k: v for k, v in r['history'].items()
              if k != 'examples_per_sec'} for r in ranks]
  assert metrics[0] == metrics[1]      # every rank holds the global metrics
  assert np.isfinite(ranks[0]['history']['loss'])
  with open(run_dir / 'metrics.jsonl') as f:
    assert len(f.read().splitlines()) == 2          # one writer
  steps = sorted(os.listdir(run_dir / 'checkpoints'))
  assert 'ckpt_4.pt' in steps
  export = checkpoint.load_params(str(run_dir / 'export' / 'latest'))
  # The table is whole in the export: 100 rows over 2 ranks, unpadded.
  table = export['scorer.embed_query_tokens.embedding']
  assert table.shape == (BUCKETS, DIM)
  # The checkpoint of the two ranks restores on one card.
  state = _one_card_state()
  checkpoint.CheckpointManager(str(run_dir / 'checkpoints')).restore(state)
  assert state.step == 4
  for k, v in state.model.state_dict().items():
    assert torch.equal(v, export[k]), k
  # The export scores as the live sharded model.
  state.model.eval()
  batch = ranks[0]['batch']
  with torch.no_grad():
    got = state.model(batch.context, batch.examples, batch.mask)
  for r in ranks:
    np.testing.assert_allclose(got.numpy(), r['logits'], rtol=1e-6,
                               atol=1e-6)
