"""Multi-task ranking: one shared scorer body, per-task losses and metrics.

The port's ``examples/multitask_ranking.py``, the counterpart of the
reference's ``MultiTaskPipeline`` + ``MultiLabelDatasetBuilder``: the
dataset carries one label feature per task; ``MultiLabelDatasetBuilder``
parses them into dict labels, and a shared tower emits one logit head per
task, each with its own loss (weighted into the total) and metric suite.

ELWC data with a single ``relevance`` label first gets a two-label copy (a
simulated binary ``click`` feature on every document), and then trains
entirely through the dataset-builder path. On the card::

  python -m ranking_tpu_torch.examples.multitask_ranking \\
    --train_pattern=train.tfrecord --valid_pattern=eval.tfrecord

``--device=cpu`` runs on the CPU.
"""

import argparse
import glob
import os
from typing import Optional, Sequence

# The model's initial draws.
INIT_SEED = 0


def parse_args(argv: Optional[Sequence[str]] = None):
  p = argparse.ArgumentParser()
  p.add_argument('--train_pattern', required=True)
  p.add_argument('--valid_pattern', required=True)
  p.add_argument('--model_dir', default='/tmp/ranking_multitask')
  p.add_argument('--batch_size', type=int, default=8)
  p.add_argument('--list_size', type=int, default=20)
  p.add_argument('--hash_buckets', type=int, default=10000)
  p.add_argument('--embedding_dim', type=int, default=8)
  p.add_argument('--hidden_layer_dims', default='64,32')
  p.add_argument('--learning_rate', type=float, default=0.05)
  p.add_argument('--num_epochs', type=int, default=3)
  p.add_argument('--steps_per_epoch', type=int, default=10)
  p.add_argument('--validation_steps', type=int, default=5)
  p.add_argument('--device', default='cuda', help="'cuda' or 'cpu'.")
  return p.parse_args(argv)


def add_click_labels(src_pattern: str, out_path: str, seed: int = 11) -> str:
  """Copies ELWC records, adding a binary ``click`` feature per document:
  relevant documents are clicked w.p. 0.7, irrelevant never (the click
  simulation of the unbiased-LTR literature, kept deliberately simple).
  The records are decoded and written again with the port's wire-format
  code (``data/proto.py``); a feature without a value list is left out.
  A pattern that matches no file raises ``FileNotFoundError``."""
  import numpy as np

  from ranking_tpu_torch.data import proto, tfrecord

  def values(features):
    return {name: list(f.values) for name, f in features.items()}

  paths = sorted(glob.glob(src_pattern))
  if not paths:
    raise FileNotFoundError(f'No files match {src_pattern!r}')
  rng = np.random.RandomState(seed)
  out = []
  for path in paths:
    for rec in tfrecord.read_records(path):
      context, examples = proto.decode_elwc(rec)
      docs = []
      for fmap in examples:
        rel = fmap.get('relevance')
        rel = rel.values if rel is not None and rel.kind == proto.INT64_LIST \
            else []
        relevant = bool(len(rel)) and rel[0] > 0
        click = int(relevant and rng.rand() < 0.7)
        doc = values(fmap)
        clicks = fmap.get('click')
        doc['click'] = (list(clicks.values) if clicks is not None
                        and clicks.kind == proto.INT64_LIST else []) + [click]
        docs.append(doc)
      out.append(proto.make_elwc(values(context), docs))
  tfrecord.write_records(out_path, out)
  return out_path


def build_model(args, generator=None):
  from ranking_tpu_torch.models import scorers
  return scorers.RankingModel(
      scorer=scorers.MultiTaskScorer(
          task_names=('relevance', 'click'),
          body=scorers.EmbeddingDNNScorer(
              tuple(int(h) for h in args.hidden_layer_dims.split(',')),
              output_units=2,
              vocab_sizes={'query_tokens': args.hash_buckets,
                           'document_tokens': args.hash_buckets},
              embedding_dim=args.embedding_dim,
              dropout=0.3, generator=generator)))


def main(argv: Optional[Sequence[str]] = None):
  """Runs the CLI; returns the ``MultiTaskPipeline`` and its last epoch's
  metrics."""
  args = parse_args(argv)
  import torch
  from ranking_tpu_torch.data.parsers import FixedLenFeature, VarLenFeature
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.pipeline import hparams as hparams_lib
  from ranking_tpu_torch.pipeline import pipeline
  from ranking_tpu_torch.utils.device import resolve_device

  device = resolve_device(args.device)
  os.makedirs(args.model_dir, exist_ok=True)
  train_path = add_click_labels(
      args.train_pattern, os.path.join(args.model_dir, 'train_2label.tfrecord'))
  valid_path = add_click_labels(
      args.valid_pattern, os.path.join(args.model_dir, 'valid_2label.tfrecord'),
      seed=12)

  context_spec = {
      'query_tokens': VarLenFeature(dtype='string', max_len=10,
                                    hash_buckets=args.hash_buckets)}
  example_spec = {
      'document_tokens': VarLenFeature(dtype='string', max_len=60,
                                       hash_buckets=args.hash_buckets),
      'relevance': FixedLenFeature(shape=(), dtype='int64', default_value=0),
      'click': FixedLenFeature(shape=(), dtype='int64', default_value=0)}

  builder = pipeline.MultiLabelDatasetBuilder(
      context_spec, example_spec,
      label_spec={'relevance': 'relevance', 'click': 'click'},
      hparams=hparams_lib.DatasetHparams(
          train_input_pattern=train_path,
          valid_input_pattern=valid_path,
          train_batch_size=args.batch_size,
          valid_batch_size=args.batch_size,
          list_size=args.list_size))

  model = build_model(args, torch.Generator().manual_seed(INIT_SEED))

  hparams = hparams_lib.PipelineHparams(
      model_dir=args.model_dir,
      num_epochs=args.num_epochs,
      steps_per_epoch=args.steps_per_epoch,
      validation_steps=args.validation_steps,
      learning_rate=args.learning_rate,
      loss={'relevance': loss_registry.RankingLossKey.SOFTMAX_LOSS,
            'click': loss_registry.RankingLossKey.SIGMOID_CROSS_ENTROPY_LOSS},
      loss_weights={'relevance': 1.0, 'click': 0.3})

  pipe = pipeline.MultiTaskPipeline(model, builder, hparams,
                                    device=device)
  history = pipe.train_and_validate(verbose=True)
  print('final:', {k: round(v, 4) for k, v in history.items()})
  return pipe, history


if __name__ == '__main__':
  main()
