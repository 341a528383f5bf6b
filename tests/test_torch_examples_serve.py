"""The port's ``trec_eval`` and ``serve_predict`` CLIs against the JAX CLIs,
on the CPU.

``trec_eval``: over qrels and a run file that the test writes (judged
documents the run lacks, retrieved ones without judgments, a query of one
side only), the printed JSON equals the JAX CLI's within ``METRIC_TOL``
(1e-6 + 1e-6 of the value).

``serve_predict``: a JAX model's Orbax export is carried over to the port's
export (``convert.from_flax``, ``checkpoint.export_params``); over the same
ELWC file both CLIs write their CSVs: the record, position and relevance
columns are equal exactly, the scores within rtol 1e-5. The port's
``--artifact_path --quantize=int8`` artifact, served by ``load_predictor``,
is within 0.03 of the largest float score (the JAX test's bound).
"""

import csv
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from ranking_tpu_torch import convert
from ranking_tpu_torch.examples import serve_predict as serve_cli
from ranking_tpu_torch.examples import trec_eval as trec_cli
from ranking_tpu_torch.pipeline import export as export_lib
from ranking_tpu_torch.train import checkpoint
from ranking_tpu_torch.train import state as state_lib

import test_torch_elwc_cli
import torch_cli_cases

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

METRIC_TOL = 1e-6
# 1,100 x 4 tables: int8 quantizes matrices of at least 4,096 entries.
BUCKETS, DIM = 1100, 4


def _run(monkeypatch, capsys, name, argv):
  mod = torch_cli_cases.load_jax_cli(name)
  monkeypatch.setattr(sys, 'argv', [f'{name}.py'] + list(argv))
  out = mod.main()
  return out, capsys.readouterr().out


def test_trec_eval_prints_the_jax_cli_json(tmp_path, monkeypatch, capsys):
  rng = np.random.RandomState(0)
  qrels, run = [], []
  for q in range(40):
    docs = [f'd{q}_{i}' for i in range(rng.randint(1, 30))]
    for d in docs:
      if rng.rand() < 0.8:
        qrels.append(f'q{q} 0 {d} {rng.randint(0, 5)}')
    ranked = [d for d in docs if rng.rand() < 0.85] + [f'x{q}_{i}'
                                                       for i in range(3)]
    for rank, d in enumerate(rng.permutation(ranked)):
      run.append(f'q{q} Q0 {d} {rank + 1} {rng.randn():.6f} r')
  qrels.append('lonely 0 d 3')
  run.append('orphan Q0 d 1 0.5 r')
  (tmp_path / 'qrels.txt').write_text('\n'.join(qrels) + '\n')
  (tmp_path / 'run.txt').write_text('\n'.join(run) + '\n')
  argv = [f'--qrels={tmp_path / "qrels.txt"}', f'--run={tmp_path / "run.txt"}',
          '--metrics=ndcg@1,ndcg@5,ndcg,mrr,mrr@10:rel>=3,map',
          '--batch_size=16']
  _, jax_out = _run(monkeypatch, capsys, 'trec_eval', argv)
  got = trec_cli.main(argv + ['--device=cpu'])
  port_out = capsys.readouterr().out
  want = json.loads(jax_out.strip().splitlines()[-1])
  line = json.loads(port_out.strip().splitlines()[-1])
  assert list(line) == list(want) and line == got
  for k, v in want.items():
    assert abs(line[k] - v) <= METRIC_TOL + METRIC_TOL * abs(v), k
  assert [l.split('=')[0] for l in port_out.splitlines()[:-1]] == [
      l.split('=')[0] for l in jax_out.splitlines()[:-1]]


def _rows(path):
  with open(path) as f:
    rows = list(csv.reader(f))
  return rows[0], rows[1:]


def test_serve_predict_scores_as_the_jax_cli(tmp_path, monkeypatch, capsys):
  from ranking_tpu import models as jax_models
  from ranking_tpu.train import checkpoint as jax_checkpoint

  data = tmp_path / 'eval.tfrecord'
  test_torch_elwc_cli._write(str(data), 11, 3)
  common = [f'--input={data}', '--batch_size=4', '--list_size=6',
            '--query_tokens=3', '--document_tokens=5',
            f'--hash_buckets={BUCKETS}', f'--embedding_dim={DIM}',
            '--hidden_layer_dims=8,4']

  # A JAX model with its BN statistics moved off their initial values.
  jmodel = jax_models.RankingModel(scorer=jax_models.EmbeddingDNNScorer(
      hidden_layer_dims=(8, 4),
      vocab_sizes={'query_tokens': BUCKETS, 'document_tokens': BUCKETS},
      embedding_dim=DIM, dropout=0.0))
  ids = np.zeros((2, 3), np.int32)
  variables = jax.jit(jmodel.init)(jax.random.PRNGKey(3),
                                   {'query_tokens': ids},
                                   {'document_tokens': np.zeros(
                                       (2, 6, 5), np.int32)},
                                   np.ones((2, 6), bool))
  rng = np.random.RandomState(4)
  variables = jax.tree_util.tree_map(
      lambda x: np.asarray(x) + rng.uniform(0.1, 0.5, np.shape(x)).astype(
          np.float32), variables)
  jax_export = str(tmp_path / 'jax_export')
  jax_checkpoint.export_params(
      type('State', (), {'params': variables['params'],
                         'batch_stats': variables['batch_stats']}),
      jax_export)

  # The same values as the port's export.
  port_export = str(tmp_path / 'port_export')
  model = serve_cli.build_model(serve_cli.parse_args(
      ['--export_path=x', '--input=x'] + common))
  model.load_state_dict(convert.from_flax(
      jax_checkpoint.load_params(jax_export)), strict=True)
  checkpoint.export_params(state_lib.create_train_state(model, device='cpu'),
                           port_export)

  _run(monkeypatch, capsys, 'serve_predict',
       [f'--export_path={jax_export}', f'--output={tmp_path / "jax.csv"}']
       + common)
  artifact = str(tmp_path / 'artifact')
  predictor = serve_cli.main(
      [f'--export_path={port_export}', f'--output={tmp_path / "port.csv"}',
       f'--artifact_path={artifact}', '--quantize=int8', '--device=cpu']
      + common)
  out = capsys.readouterr().out.splitlines()
  assert out == [f'self-contained artifact -> {artifact} (quantize=int8)',
                 f'scored 11 lists -> {tmp_path / "port.csv"}']

  head, jax_rows = _rows(tmp_path / 'jax.csv')
  port_head, port_rows = _rows(tmp_path / 'port.csv')
  assert port_head == head == ['record', 'position', 'relevance', 'score']
  assert [r[:3] for r in port_rows] == [r[:3] for r in jax_rows]
  np.testing.assert_allclose([float(r[3]) for r in port_rows],
                             [float(r[3]) for r in jax_rows], rtol=1e-5,
                             atol=1e-6)

  from ranking_tpu_torch.data import tfrecord
  records = tfrecord.read_all_records(str(data))
  want = predictor.predict(records)
  got = export_lib.load_predictor(artifact, device='cpu').predict(records)
  valid = want > -20.0          # padded slots score log(1e-10)
  largest = float(np.abs(want[valid]).max())
  assert np.abs(got - want)[valid].max() <= 0.03 * largest
  np.testing.assert_array_equal(got[~valid], want[~valid])


def test_serve_predict_quantize_needs_an_artifact():
  with pytest.raises(SystemExit):
    serve_cli.parse_args(['--export_path=x', '--input=x', '--quantize=int8'])
