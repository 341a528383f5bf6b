"""Document Interaction Network ranker on ANTIQUE-style ELWC data.

The port's ``examples/antique_din.py``, the counterpart of the reference's
examples/keras/antique_kpl_din.py: token embeddings + cross-document
self-attention (``DocumentInteractionAttention``) scorer, trained listwise.
The same scorer configured with the DASALC hyperparameters (4 attention
layers x 2 heads x 100, hidden 512-256-128; research/dasalc.py) reproduces
the DASALC architecture: pass ``--dasalc``. On the card::

  python -m ranking_tpu_torch.examples.antique_din \\
    --train_pattern=train.tfrecord --valid_pattern=eval.tfrecord

``--device=cpu`` runs on the CPU.
"""

import argparse
from typing import Optional, Sequence

import torch
from torch import nn

# The model's initial draws.
INIT_SEED = 0


def parse_args(argv: Optional[Sequence[str]] = None):
  p = argparse.ArgumentParser()
  p.add_argument('--train_pattern', required=True)
  p.add_argument('--valid_pattern', required=True)
  p.add_argument('--model_dir', default='/tmp/ranking_din')
  p.add_argument('--batch_size', type=int, default=8)
  p.add_argument('--list_size', type=int, default=50)
  p.add_argument('--hash_buckets', type=int, default=10000)
  p.add_argument('--embedding_dim', type=int, default=20)
  p.add_argument('--num_heads', type=int, default=2)
  p.add_argument('--head_size', type=int, default=100)
  p.add_argument('--num_attention_layers', type=int, default=1)
  p.add_argument('--hidden_layer_dims', default='64,32')
  p.add_argument('--loss', default='approx_ndcg_loss')
  p.add_argument('--learning_rate', type=float, default=0.05)
  p.add_argument('--num_epochs', type=int, default=5)
  p.add_argument('--steps_per_epoch', type=int, default=10)
  p.add_argument('--validation_steps', type=int, default=10)
  p.add_argument('--dasalc', action='store_true',
                 help='Use the DASALC paper configuration.')
  p.add_argument('--device', default='cuda', help="'cuda' or 'cpu'.")
  return p.parse_args(argv)


class Scorer(nn.Module):
  """Pooled query tokens (``embed_q``) and document tokens (``embed_d``)
  into a ``DINScorer`` (``din``, flax ``DINScorer_0``)."""

  def __init__(self, vocab_size: int, embedding_dim: int, num_heads: int,
               head_size: int, num_attention_layers: int,
               hidden_layer_dims: Sequence[int],
               generator: Optional[torch.Generator] = None):
    super().__init__()
    from ranking_tpu_torch.models import embeddings as emb
    from ranking_tpu_torch.models import scorers
    generator = torch.Generator() if generator is None else generator
    self.embed_q = emb.EmbeddingEncoder(vocab_size, embedding_dim,
                                        generator=generator)
    self.embed_d = emb.EmbeddingEncoder(vocab_size, embedding_dim,
                                        generator=generator)
    self.din = scorers.DINScorer(
        2 * embedding_dim, num_heads=num_heads, head_size=head_size,
        num_attention_layers=num_attention_layers,
        hidden_layer_dims=hidden_layer_dims, dropout=0.5,
        generator=generator)

  def forward(self, context, examples, mask, training=False, generator=None):
    ctx = {'q': self.embed_q(context['query_tokens'])}
    exs = {'d': self.embed_d(examples['document_tokens'])}
    return self.din(ctx, exs, mask, training=training, generator=generator)


def _din_with_embeddings(args, vocab_size, generator=None):
  """Builds a RankingModel composing token embeddings with the DIN
  scorer (a plain factory: it returns a RankingModel)."""
  from ranking_tpu_torch.models import scorers
  if args.dasalc:
    num_layers, num_heads, head_size = 4, 2, 100
    hidden = (512, 256, 128)
  else:
    num_layers = args.num_attention_layers
    num_heads, head_size = args.num_heads, args.head_size
    hidden = tuple(int(h) for h in args.hidden_layer_dims.split(','))
  return scorers.RankingModel(scorer=Scorer(
      vocab_size, args.embedding_dim, num_heads, head_size, num_layers,
      hidden, generator=generator))


def main(argv: Optional[Sequence[str]] = None):
  """Runs the CLI; returns the ``SimplePipeline`` and its last epoch's
  metrics."""
  args = parse_args(argv)
  from ranking_tpu_torch.data.parsers import FixedLenFeature, VarLenFeature
  from ranking_tpu_torch.pipeline import hparams as hparams_lib
  from ranking_tpu_torch.pipeline import pipeline
  from ranking_tpu_torch.utils.device import resolve_device

  device = resolve_device(args.device)
  context_spec = {
      'query_tokens': VarLenFeature(dtype='string', max_len=10,
                                    hash_buckets=args.hash_buckets)}
  example_spec = {
      'document_tokens': VarLenFeature(dtype='string', max_len=60,
                                       hash_buckets=args.hash_buckets),
      'relevance': FixedLenFeature(shape=(), dtype='int64', default_value=0)}

  model = _din_with_embeddings(args, args.hash_buckets,
                               torch.Generator().manual_seed(INIT_SEED))
  builder = pipeline.SimpleDatasetBuilder(
      context_spec, example_spec,
      hparams_lib.DatasetHparams(
          train_input_pattern=args.train_pattern,
          valid_input_pattern=args.valid_pattern,
          train_batch_size=args.batch_size,
          valid_batch_size=args.batch_size,
          list_size=args.list_size))
  hparams = hparams_lib.PipelineHparams(
      model_dir=args.model_dir,
      num_epochs=args.num_epochs,
      steps_per_epoch=args.steps_per_epoch,
      validation_steps=args.validation_steps,
      learning_rate=args.learning_rate,
      loss=args.loss)
  pipe = pipeline.SimplePipeline(model, builder, hparams, device=device)
  history = pipe.train_and_validate(verbose=True)
  print('final:', {k: round(v, 4) for k, v in history.items()})
  return pipe, history


if __name__ == '__main__':
  main()
