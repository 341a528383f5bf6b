"""Batch inference from an exported model: ELWC records in, scores out.

The port's ``examples/serve_predict.py``, the serving-side counterpart of
the SavedModel predict signature: loads exported params
(``checkpoint.export_params``), parses a TFRecord of ExampleListWithContext
protos, scores every list with ``Predictor.predict``, and writes a CSV of
(record_index, position, relevance, score) rows. After
``ranking_tpu_torch.examples.ranking_elwc_pipeline`` has exported a model,
on the card::

  python -m ranking_tpu_torch.examples.serve_predict \\
    --export_path=/tmp/ranking_elwc/export/latest \\
    --input=eval.tfrecord --output=/tmp/scores.csv

``--artifact_path`` also writes a self-contained ``torch.export`` artifact
(``pipeline/export.py``; ``load_predictor`` serves it without the model
code), ``--quantize=int8`` with int8 weights. ``--device=cpu`` runs on the
CPU.
"""

import argparse
import csv
from typing import Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None):
  p = argparse.ArgumentParser()
  p.add_argument('--export_path', required=True)
  p.add_argument('--input', required=True, help='ELWC TFRecord file')
  p.add_argument('--output', default='/dev/stdout')
  p.add_argument('--artifact_path', default=None,
                 help='also write a self-contained torch.export artifact '
                      'here')
  p.add_argument('--quantize', default=None, choices=['int8'],
                 help='weight-only quantization for the artifact (~4x '
                      'smaller params; dequant baked into the graph)')
  p.add_argument('--batch_size', type=int, default=32)
  p.add_argument('--list_size', type=int, default=50)
  p.add_argument('--hash_buckets', type=int, default=10000)
  p.add_argument('--query_tokens', type=int, default=10)
  p.add_argument('--document_tokens', type=int, default=60)
  p.add_argument('--embedding_dim', type=int, default=20)
  p.add_argument('--hidden_layer_dims', default='64,32,16')
  p.add_argument('--device', default='cuda', help="'cuda' or 'cpu'.")
  args = p.parse_args(argv)
  if args.quantize and not args.artifact_path:
    p.error('--quantize requires --artifact_path (it only affects the '
            'self-contained artifact)')
  return args


def build_model(args):
  """The exported model's architecture (its values come from the export)."""
  from ranking_tpu_torch.models import scorers
  return scorers.RankingModel(
      scorer=scorers.EmbeddingDNNScorer(
          tuple(int(h) for h in args.hidden_layer_dims.split(',')),
          vocab_sizes={'query_tokens': args.hash_buckets,
                       'document_tokens': args.hash_buckets},
          embedding_dim=args.embedding_dim,
          dropout=0.0))


def main(argv: Optional[Sequence[str]] = None):
  """Runs the CLI; returns the ``Predictor``."""
  args = parse_args(argv)
  import torch
  from ranking_tpu_torch.data import parsers
  from ranking_tpu_torch.data import tfrecord
  from ranking_tpu_torch.data.parsers import FixedLenFeature, VarLenFeature
  from ranking_tpu_torch.pipeline import serving
  from ranking_tpu_torch.utils.device import resolve_device

  device = resolve_device(args.device)
  context_spec = {
      'query_tokens': VarLenFeature(dtype='string',
                                    max_len=args.query_tokens,
                                    hash_buckets=args.hash_buckets)}
  example_spec = {
      'document_tokens': VarLenFeature(dtype='string',
                                       max_len=args.document_tokens,
                                       hash_buckets=args.hash_buckets),
      'relevance': FixedLenFeature(shape=(), dtype='int64',
                                   default_value=0)}

  predictor = serving.Predictor.from_export(
      build_model(args), args.export_path, context_spec, example_spec,
      list_size=args.list_size, label_feature_name='relevance',
      device=device)

  records = tfrecord.read_all_records(args.input)

  if args.artifact_path:
    # Self-contained artifact: loadable by pipeline.export.load_predictor
    # in a process with no model code (keras saved_model.py Signatures
    # analog). Traced on the CPU from the predictor's loaded values.
    from ranking_tpu_torch.data.batch import RankingBatch
    from ranking_tpu_torch.pipeline import export as export_lib
    sample = parsers.parse_example_list(
        records[:2], context_spec,
        {k: v for k, v in example_spec.items() if k != 'relevance'},
        list_size=args.list_size)
    export_lib.export_predictor(
        build_model(args), {k: v.detach().cpu() for k, v in
                            predictor.model.state_dict().items()},
        context_spec, example_spec, args.artifact_path,
        sample_batch=RankingBatch(
            context={k: torch.from_numpy(v)
                     for k, v in sample.context.items()},
            examples={k: torch.from_numpy(v)
                      for k, v in sample.examples.items()},
            labels=torch.from_numpy(
                np.where(sample.mask, 0.0, -1.0).astype('float32')),
            mask=torch.from_numpy(sample.mask)),
        list_size_buckets=(args.list_size,),
        label_feature_name='relevance', quantize=args.quantize)
    print(f'self-contained artifact -> {args.artifact_path}'
          + (f' (quantize={args.quantize})' if args.quantize else ''))
  with open(args.output, 'w', newline='') as f:
    writer = csv.writer(f)
    writer.writerow(['record', 'position', 'relevance', 'score'])
    for start in range(0, len(records), args.batch_size):
      chunk = records[start:start + args.batch_size]
      scores = predictor.predict(chunk)
      parsed = parsers.parse_example_list(
          chunk, {}, {'relevance': example_spec['relevance']},
          list_size=args.list_size)
      for i in range(len(chunk)):
        for pos in range(int(parsed.sizes[i])):
          writer.writerow([start + i, pos,
                           int(parsed.examples['relevance'][i, pos]),
                           float(scores[i, pos])])
  print(f'scored {len(records)} lists -> {args.output}')
  return predictor


if __name__ == '__main__':
  main()
