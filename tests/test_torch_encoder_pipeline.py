"""An encoder model through the port's pipeline, checkpoints and serving
artifact, on the CPU.

``SimplePipeline.train_and_validate`` over ELWC files in TFRBertDataLoader's
format (int64 ``input_ids``, ``input_mask`` and ``segment_ids`` of length T:
``examples/encoder_ranking.py``'s spec), K = 2 steps a dispatch, then
``export_predictor`` float32 and int8 served by ``load_predictor``: float32
== the live ``Predictor`` at rtol 1e-5, atol 1e-5 (the same float32
arithmetic through the exported program); int8 within 0.03 of the largest
float score (the JAX export test's bound). No JAX here: the JAX package's
own pipeline tests cover its side.
"""

import os

import numpy as np
import torch

from ranking_tpu_torch.data import parsers, proto, tfrecord
from ranking_tpu_torch.models import encoder
from ranking_tpu_torch.models import scorers
from ranking_tpu_torch.pipeline import export, hparams as hparams_lib
from ranking_tpu_torch.pipeline import pipeline, serving

if os.environ.get('PYTEST_XDIST_WORKER'):
  torch.set_num_threads(1)

V, H, HEADS, T = 50, 16, 2, 8
L = 4
FWD = dict(rtol=1e-5, atol=1e-5)


def _bert_elwc(rng, lists):
  """ELWC lists of 2 to L documents in TFRBertDataLoader's format: int64
  ``input_ids``, ``input_mask`` and ``segment_ids`` of length T, and an
  int64 ``relevance``."""
  out = []
  for _ in range(lists):
    docs = []
    for _ in range(rng.randint(2, L + 1)):
      n = rng.randint(3, T + 1)
      docs.append({
          'input_ids': np.pad(rng.randint(1, V, size=n), (0, T - n)),
          'input_mask': np.pad(np.ones(n, np.int64), (0, T - n)),
          'segment_ids': np.pad((np.arange(n) >= n // 2).astype(np.int64),
                                (0, T - n)),
          'relevance': [int(rng.randint(0, 3))]})
    out.append(proto.make_elwc({}, docs))
  return out


def test_pipeline_checkpoint_export_and_serving(tmp_path):
  """SimplePipeline over ELWC files in TFRBertDataLoader's format (flat
  [B*L, T] example leaves restored by the step), its checkpoints, and the
  exported artifact: float32 == the live predictor at rtol 1e-5, atol 1e-5;
  int8 within 0.03 of the largest float score."""
  rng = np.random.RandomState(12)
  for split, lists in (('train', 16), ('vali', 8)):
    tfrecord.write_records(str(tmp_path / f'{split}.tfrecord'),
                           _bert_elwc(rng, lists))
  spec = {name: parsers.FixedLenFeature((T,), 'int64', 0)
          for name in ('input_ids', 'input_mask', 'segment_ids')}
  spec['relevance'] = parsers.FixedLenFeature((), 'int64', 0)
  builder = pipeline.SimpleDatasetBuilder(
      {}, spec, hparams_lib.DatasetHparams(
          train_input_pattern=str(tmp_path / 'train.tfrecord'),
          valid_input_pattern=str(tmp_path / 'vali.tfrecord'),
          train_batch_size=4, valid_batch_size=4, list_size=L), seed=0)
  model = scorers.RankingModel(encoder.EncoderScorer(
      # mlp 256: Dense_0's [16, 256] kernel is large enough for int8.
      encoder.TransformerEncoder(V, H, 1, HEADS, 256, T, type_vocab_size=2,
                                 dropout=0.1, generator=torch.Generator()
                                 .manual_seed(1)), dropout=0.1))
  hp = hparams_lib.PipelineHparams(
      model_dir=str(tmp_path / 'model'), num_epochs=1, steps_per_epoch=4,
      validation_steps=2, learning_rate=1e-3, loss='softmax_loss',
      steps_per_execution=2)
  pipe = pipeline.SimplePipeline(model, builder, hp, device='cpu')
  history = pipe.train_and_validate()
  assert pipe.final_state.step == 4
  assert all(np.isfinite(v) for v in history.values())
  assert (tmp_path / 'model' / 'checkpoints').is_dir()
  records = _bert_elwc(np.random.RandomState(13), 6)
  live = serving.Predictor(model, example_feature_spec=spec, list_size=L,
                           label_feature_name='relevance',
                           device='cpu').predict(records)
  sample = next(iter(builder.valid_batches()))
  scores = {}
  for quant in (None, 'int8'):
    path = str(tmp_path / f'export_{quant}')
    export.export_predictor(model, None, {}, spec, path, sample,
                            list_size_buckets=(L,),
                            label_feature_name='relevance', quantize=quant)
    scores[quant] = export.load_predictor(path, device='cpu').predict(
        records)
  np.testing.assert_allclose(scores[None], live, **FWD)
  valid = live > np.log(1e-10)
  scale = np.abs(live[valid]).max()
  assert np.abs(scores['int8'] - live)[valid].max() <= 0.03 * scale
