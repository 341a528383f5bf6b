"""End-to-end ELWC pipeline: the port's ``examples/ranking_elwc_pipeline.py``.

Trains an embedding + DNN ranker on ExampleListWithContext TFRecords
through ``SimplePipeline``: query tokens (context) and document tokens
(examples) hashed (or looked up in ``--vocab_file``), pooled embeddings, a
DNN tower, checkpoints, event logs and the params export under
``--model_dir``.

On one card::

  python -m ranking_tpu_torch.examples.ranking_elwc_pipeline \\
    --train_pattern=train.tfrecord --valid_pattern=eval.tfrecord

Over N ranks, one card each (NCCL), the tables row-sharded over 2 of them::

  torchrun --nproc_per_node=N -m ranking_tpu_torch.examples.ranking_elwc_pipeline \\
    --train_pattern=... --valid_pattern=... --mesh_model=2

``--device=cpu`` runs on the CPU (over gloo under ``torchrun``);
``--backend=gloo`` runs CUDA ranks over gloo, through host memory, which
lets several ranks share one card. Every rank reads the global stream and
keeps its rows; the first rank alone prints and writes.
"""

import argparse
import os
from typing import Optional, Sequence

# The model's initial draws, the train stream's shuffle and the steps'
# random stream (``PipelineHparams.seed``'s default): one seed, so that
# every rank reads the same global stream.
SEED = 1


def parse_args(argv: Optional[Sequence[str]] = None):
  p = argparse.ArgumentParser()
  p.add_argument('--train_pattern', required=True)
  p.add_argument('--valid_pattern', required=True)
  p.add_argument('--vocab_file', default=None,
                 help='Optional token vocabulary; hashing is used if absent.')
  p.add_argument('--model_dir', default='/tmp/ranking_elwc')
  p.add_argument('--batch_size', type=int, default=8)
  p.add_argument('--list_size', type=int, default=50)
  p.add_argument('--query_tokens', type=int, default=10)
  p.add_argument('--document_tokens', type=int, default=60)
  p.add_argument('--hash_buckets', type=int, default=10000)
  p.add_argument('--embedding_dim', type=int, default=20)
  p.add_argument('--hidden_layer_dims', default='64,32,16')
  p.add_argument('--loss', default='approx_ndcg_loss')
  p.add_argument('--learning_rate', type=float, default=0.05)
  p.add_argument('--optimizer', default='adam',
                 help='adam|adagrad|sgd|adamw|lazy_adam|lazy_adagrad '
                      '(sparse-row embedding updates)')
  p.add_argument('--num_epochs', type=int, default=5)
  p.add_argument('--steps_per_epoch', type=int, default=10)
  p.add_argument('--validation_steps', type=int, default=10)
  p.add_argument('--mesh_model', type=int, default=1,
                 help='Ranks on the model axis: >1 row-shards the '
                      'embedding tables with the explicit-collective lookup '
                      '(the ParameterServer-partitioning analog).')
  p.add_argument('--weights_feature', default=None,
                 help='Example feature holding per-example weights (IPW '
                      'unbiased-LTR reweighting).')
  p.add_argument('--device', default='cuda',
                 help="'cuda' (one card a rank) or 'cpu'.")
  p.add_argument('--backend', default=None,
                 help='Process-group backend: nccl for CUDA ranks, gloo for '
                      'CPU ones, unless set.')
  p.add_argument('--init_method', default=None,
                 help="Rendezvous of the process group (default env://, as "
                      "torchrun sets it up).")
  return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
  """Runs the CLI; returns the ``SimplePipeline`` (its ``final_state``,
  ``mesh``) and the last epoch's metrics."""
  args = parse_args(argv)
  import torch
  from torch import nn
  from ranking_tpu_torch import parallel
  from ranking_tpu_torch.data.parsers import (FixedLenFeature, VarLenFeature,
                                              Vocabulary)
  from ranking_tpu_torch.models import scorers
  from ranking_tpu_torch.pipeline import hparams as hparams_lib
  from ranking_tpu_torch.pipeline import pipeline
  from ranking_tpu_torch.utils.device import resolve_device

  device = resolve_device(args.device)
  if int(os.environ.get('WORLD_SIZE', 1)) > 1 or args.init_method:
    device = parallel.init_distributed(args.device,
                                       init_method=args.init_method,
                                       backend=args.backend)
  vocab = Vocabulary(args.vocab_file) if args.vocab_file else None
  tok = dict(vocab=vocab) if vocab else dict(hash_buckets=args.hash_buckets)
  vocab_size = vocab.size if vocab else args.hash_buckets

  context_spec = {
      'query_tokens': VarLenFeature(dtype='string',
                                    max_len=args.query_tokens, **tok)}
  example_spec = {
      'document_tokens': VarLenFeature(dtype='string',
                                       max_len=args.document_tokens, **tok),
      'relevance': FixedLenFeature(shape=(), dtype='int64', default_value=0)}
  if args.weights_feature:
    example_spec[args.weights_feature] = FixedLenFeature(
        shape=(), dtype='float32', default_value=1.0)

  mesh = None
  if args.mesh_model > 1:
    # Tables pad themselves to the model axis; any vocab size works.
    mesh = parallel.make_mesh(model=args.mesh_model)

  scorer = scorers.EmbeddingDNNScorer(
      tuple(int(h) for h in args.hidden_layer_dims.split(',')),
      vocab_sizes={'query_tokens': vocab_size,
                   'document_tokens': vocab_size},
      embedding_dim=args.embedding_dim, mesh=mesh, dropout=0.5,
      generator=torch.Generator().manual_seed(SEED))
  if args.weights_feature:
    # The IPW weight reaches ONLY the loss: feeding it to the scorer would
    # leak logged-position information into the relevance model and skew
    # train against serve.
    class _DropWeightFeature(nn.Module):

      def __init__(self, inner, drop):
        super().__init__()
        self.inner, self.drop = inner, drop

      def forward(self, context, examples, mask, training=False, **kwargs):
        examples = {k: v for k, v in examples.items() if k != self.drop}
        return self.inner(context, examples, mask, training=training,
                          **kwargs)

    scorer = _DropWeightFeature(scorer, args.weights_feature)
  model = scorers.RankingModel(scorer=scorer)

  builder = pipeline.SimpleDatasetBuilder(
      context_spec, example_spec,
      hparams_lib.DatasetHparams(
          train_input_pattern=args.train_pattern,
          valid_input_pattern=args.valid_pattern,
          train_batch_size=args.batch_size,
          valid_batch_size=args.batch_size,
          list_size=args.list_size,
          shuffle_buffer_size=1000), seed=SEED)

  hparams = hparams_lib.PipelineHparams(
      model_dir=args.model_dir,
      num_epochs=args.num_epochs,
      steps_per_epoch=args.steps_per_epoch,
      validation_steps=args.validation_steps,
      learning_rate=args.learning_rate,
      loss=args.loss,
      optimizer=args.optimizer,
      mesh_model=args.mesh_model,
      weights_feature_name=args.weights_feature or None,
      export_best_model=True,
      best_exporter_metric='ndcg@5',
      best_exporter_metric_higher_better=True,
      seed=SEED)

  pipe = pipeline.SimplePipeline(model, builder, hparams, device=device,
                                 mesh=mesh)
  first = (not torch.distributed.is_initialized()
           or torch.distributed.get_rank() == 0)
  history = pipe.train_and_validate(verbose=first)
  if first:
    print('final:', {k: round(v, 4) for k, v in history.items()})
  return pipe, history


if __name__ == '__main__':
  main()
  import torch.distributed as dist
  if dist.is_initialized():
    dist.destroy_process_group()
