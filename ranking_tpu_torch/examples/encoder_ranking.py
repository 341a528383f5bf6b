"""Transformer-encoder ranker on ELWC data (TFR-BERT counterpart).

The port's ``examples/encoder_ranking.py``, the analog of the reference's
examples/keras/tfrbert_antique_train.py: each document's (query, document)
token pair is fused into one ``[CLS] q [SEP] d [SEP]`` sequence, encoded by
a ``TransformerEncoder``, and scored univariately, through
``SimplePipeline``. ``--init_checkpoint`` with ``--bert_config`` starts the
encoder from a TF2 BERT checkpoint (read without TensorFlow,
``models/bert_ckpt.py``); ``--warm_start_dir`` overlays an export of this
package (``checkpoint.export_params``) onto the model by path suffix
(``models.warm_start_from``). On the card::

  python -m ranking_tpu_torch.examples.encoder_ranking \\
    --train_pattern=train.tfrecord --valid_pattern=eval.tfrecord

``--device=cpu`` runs on the CPU.
"""

import argparse
import glob
from typing import Optional, Sequence

import numpy as np
import torch

# The model's initial draws.
INIT_SEED = 0


def parse_args(argv: Optional[Sequence[str]] = None):
  p = argparse.ArgumentParser()
  p.add_argument('--train_pattern', required=True)
  p.add_argument('--valid_pattern', required=True)
  p.add_argument('--model_dir', default='/tmp/ranking_encoder')
  p.add_argument('--warm_start_dir', default=None)
  p.add_argument('--init_checkpoint', default=None,
                 help='TF2 BERT checkpoint (e.g. bert_lite_tf2.ckpt); '
                      'requires --bert_config; reads input_ids/input_mask/'
                      'segment_ids features (TFRBertDataLoader format)')
  p.add_argument('--bert_config', default=None)
  p.add_argument('--vocab_file', default=None,
                 help='WordPiece vocab: tokenize raw query/document string '
                      'features instead of reading pre-tokenized ids')
  p.add_argument('--batch_size', type=int, default=4)
  p.add_argument('--list_size', type=int, default=10)
  p.add_argument('--seq_len', type=int, default=64)
  p.add_argument('--vocab_buckets', type=int, default=30000)
  p.add_argument('--hidden_dim', type=int, default=64)
  p.add_argument('--num_layers', type=int, default=2)
  p.add_argument('--num_heads', type=int, default=4)
  p.add_argument('--remat', action='store_true',
                 help='rematerialize encoder blocks on backward '
                      '(lower peak memory, ~1/3 extra FLOPs)')
  p.add_argument('--loss', default='softmax_loss')
  p.add_argument('--learning_rate', type=float, default=1e-3)
  # The reference TFR-BERT recipe trains adamw + linear decay to 0 with
  # ~10% linear warmup (tfrbert_antique_train_config.yaml:23-39).
  p.add_argument('--optimizer', default='adam')
  p.add_argument('--lr_schedule', default='constant',
                 choices=['constant', 'linear_decay', 'cosine_decay'])
  p.add_argument('--warmup_steps', type=int, default=0)
  p.add_argument('--gradient_clip_norm', type=float, default=0.0)
  p.add_argument('--num_epochs', type=int, default=2)
  p.add_argument('--steps_per_epoch', type=int, default=5)
  p.add_argument('--validation_steps', type=int, default=2)
  p.add_argument('--device', default='cuda', help="'cuda' or 'cpu'.")
  return p.parse_args(argv)


def _bert_input_builder():
  from ranking_tpu_torch.data import bert
  from ranking_tpu_torch.data.batch import RankingBatch
  from ranking_tpu_torch.pipeline import pipeline

  class BertInputBuilder(pipeline.SimpleDatasetBuilder):
    """Fuses query + document ids into BERT inputs on the host."""

    def __init__(self, *a, seq_len, cls_id, sep_id, **kw):
      super().__init__(*a, **kw)
      self.seq_len, self.cls_id, self.sep_id = seq_len, cls_id, sep_id

    def _batches(self, *a, **kw):
      for b in super()._batches(*a, **kw):
        fused = bert.fuse_query_document_ids(
            b.context['query_tokens'].numpy(),
            b.examples['document_tokens'].numpy(),
            seq_len=self.seq_len, cls_id=self.cls_id, sep_id=self.sep_id)
        yield RankingBatch(context={},
                           examples={'input_ids': torch.from_numpy(fused)},
                           labels=b.labels, mask=b.mask)

  return BertInputBuilder


class TokenizingBuilder:
  """ELWC reader tokenizing raw ``query`` / ``document`` string features
  with WordPiece, once at load (per-epoch WordPiece over the whole corpus
  would dominate the step feed's time)."""

  def __init__(self, train, valid, tokenizer, list_size, seq_len,
               batch_size):
    self.train, self.valid = train, valid
    self.tokenizer = tokenizer
    self.list_size, self.seq_len = list_size, seq_len
    self.batch_size = batch_size

  def _load(self, path):
    from ranking_tpu_torch.data import bert, proto, tfrecord

    def first(fmap, name, kind, default):
      f = fmap.get(name)
      return (f.values if f is not None and f.kind == kind else []) or default

    lists = []
    ls, seq_len = self.list_size, self.seq_len
    for fp in sorted(glob.glob(path)):
      for rec in tfrecord.read_records(fp):
        docs, rels, query = [], [], ''
        for f in proto.decode_elwc(rec)[1][:ls]:
          query = first(f, 'query', proto.BYTES_LIST, [b''])[0].decode()
          docs.append(first(f, 'document', proto.BYTES_LIST,
                            [b''])[0].decode())
          rel = first(f, 'relevance', proto.INT64_LIST, [])
          rels.append(float(rel[0]) if rel else 0.0)
        if not docs:
          continue  # an empty list has nothing to rank (or stack)
        ids = np.zeros((ls, seq_len), np.int32)
        ams = np.zeros_like(ids)
        segs = np.zeros_like(ids)
        labels = np.full((ls,), -1.0, np.float32)
        i, m, sg = bert.encode_query_documents(self.tokenizer, query, docs,
                                               seq_len)
        ids[:len(docs)] = i
        ams[:len(docs)] = m
        segs[:len(docs)] = sg
        labels[:len(rels)] = rels
        lists.append((ids, ams, segs, labels))
    return lists

  def _batches(self, lists, epochs, shuffle=True):
    from ranking_tpu_torch.data.batch import RankingBatch
    rng = np.random.RandomState(11)
    epoch = 0
    while epochs is None or epoch < epochs:
      epoch += 1
      order = (rng.permutation(len(lists)) if shuffle
               else np.arange(len(lists)))
      for start in range(0, len(lists), self.batch_size):
        sel = order[start:start + self.batch_size]
        if len(sel) < self.batch_size:
          continue
        chunk = [lists[j] for j in sel]
        labels = torch.from_numpy(np.stack([c[3] for c in chunk]))
        yield RankingBatch(
            context={},
            examples={
                'input_ids': torch.from_numpy(np.stack([c[0] for c in chunk])),
                'input_mask': torch.from_numpy(
                    np.stack([c[1] for c in chunk])),
                'segment_ids': torch.from_numpy(
                    np.stack([c[2] for c in chunk]))},
            labels=labels, mask=labels >= 0)

  def train_batches(self):
    return self._batches(self._load(self.train), None)

  def valid_batches(self):
    return self._batches(self._load(self.valid), 1, shuffle=False)


def build_model(args, generator: Optional[torch.Generator] = None):
  """The CLI's model: its encoder drawn from ``generator``, or the
  ``--init_checkpoint``'s; then ``--warm_start_dir``'s export overlaid.
  Returns the model and the fused sequence length."""
  from ranking_tpu_torch.models import encoder as encoder_lib
  from ranking_tpu_torch.models import scorers
  generator = torch.Generator() if generator is None else generator
  if args.init_checkpoint:
    # Pretrained-BERT mode (tfrbert_task.py:346-361 analog): the encoder's
    # config and values from the checkpoint.
    from ranking_tpu_torch.models import bert_ckpt
    encoder, _ = bert_ckpt.load_tf2_bert_checkpoint(args.init_checkpoint,
                                                   args.bert_config)
    seq_len = min(args.seq_len, encoder.max_len)
  else:
    encoder = encoder_lib.TransformerEncoder(
        vocab_size=args.vocab_buckets + 2, hidden_dim=args.hidden_dim,
        num_layers=args.num_layers, num_heads=args.num_heads,
        mlp_dim=args.hidden_dim * 4, max_len=args.seq_len,
        remat=args.remat, generator=generator)
    seq_len = args.seq_len
  model = scorers.RankingModel(scorer=encoder_lib.EncoderScorer(
      encoder=encoder, dropout=0.1, generator=generator))
  if args.warm_start_dir:
    from ranking_tpu_torch.train import checkpoint
    pretrained = checkpoint.load_params(args.warm_start_dir)
    flat = {name.replace('.', '/'): value
            for name, value in pretrained.items()}
    model.load_state_dict(encoder_lib.warm_start_from(model.state_dict(),
                                                      flat))
  return model, seq_len


def build_dataset(args, seq_len):
  """The CLI's dataset builder: fused hashed tokens, or with
  ``--init_checkpoint`` the records' own ``input_ids`` / ``input_mask`` /
  ``segment_ids`` (tokenized here with ``--vocab_file``)."""
  from ranking_tpu_torch.data import bert
  from ranking_tpu_torch.data.parsers import FixedLenFeature, VarLenFeature
  from ranking_tpu_torch.pipeline import hparams as hparams_lib
  from ranking_tpu_torch.pipeline import pipeline
  dataset_hparams = hparams_lib.DatasetHparams(
      train_input_pattern=args.train_pattern,
      valid_input_pattern=args.valid_pattern,
      train_batch_size=args.batch_size,
      valid_batch_size=args.batch_size,
      list_size=args.list_size)
  if not args.init_checkpoint:
    # Hashed tokens occupy [0, vocab_buckets); [CLS] and [SEP] above.
    cls_id, sep_id = args.vocab_buckets, args.vocab_buckets + 1
    context_spec = {
        'query_tokens': VarLenFeature(dtype='string', max_len=10,
                                      hash_buckets=args.vocab_buckets)}
    example_spec = {
        'document_tokens': VarLenFeature(dtype='string', max_len=48,
                                         hash_buckets=args.vocab_buckets),
        'relevance': FixedLenFeature(shape=(), dtype='int64',
                                     default_value=0)}
    return _bert_input_builder()(context_spec, example_spec, dataset_hparams,
                                 seq_len=seq_len, cls_id=cls_id,
                                 sep_id=sep_id)
  if args.vocab_file:
    return TokenizingBuilder(args.train_pattern, args.valid_pattern,
                             bert.WordPieceTokenizer(args.vocab_file),
                             args.list_size, seq_len, args.batch_size)
  spec = {name: FixedLenFeature(shape=(seq_len,), dtype='int64',
                                default_value=0)
          for name in ('input_ids', 'input_mask', 'segment_ids')}
  spec['relevance'] = FixedLenFeature(shape=(), dtype='int64',
                                      default_value=0)
  return pipeline.SimpleDatasetBuilder({}, spec, dataset_hparams)


def main(argv: Optional[Sequence[str]] = None):
  """Runs the CLI; returns the ``SimplePipeline`` and its last epoch's
  metrics."""
  args = parse_args(argv)
  from ranking_tpu_torch.pipeline import hparams as hparams_lib
  from ranking_tpu_torch.pipeline import pipeline
  from ranking_tpu_torch.utils.device import resolve_device

  device = resolve_device(args.device)
  model, seq_len = build_model(args, torch.Generator().manual_seed(INIT_SEED))
  builder = build_dataset(args, seq_len)
  hparams = hparams_lib.PipelineHparams(
      model_dir=args.model_dir,
      num_epochs=args.num_epochs,
      steps_per_epoch=args.steps_per_epoch,
      validation_steps=args.validation_steps,
      learning_rate=args.learning_rate,
      optimizer=args.optimizer,
      lr_schedule=args.lr_schedule,
      warmup_steps=args.warmup_steps,
      gradient_clip_norm=args.gradient_clip_norm,
      loss=args.loss)
  pipe = pipeline.SimplePipeline(model, builder, hparams, device=device)
  history = pipe.train_and_validate(verbose=True)
  print('final:', {k: round(v, 4) for k, v in history.items()})
  return pipe, history


if __name__ == '__main__':
  main()
