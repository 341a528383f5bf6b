"""Ranking model layers and scorers (eval path)."""

from ranking_tpu_torch.models import bert_ckpt
from ranking_tpu_torch.models import encoder
from ranking_tpu_torch.models.bert_ckpt import load_tf2_bert_checkpoint
from ranking_tpu_torch.models.encoder import (
    EncoderScorer,
    TransformerEncoder,
    warm_start_from,
)

__all__ = [
    'EncoderScorer',
    'TransformerEncoder',
    'bert_ckpt',
    'encoder',
    'load_tf2_bert_checkpoint',
    'warm_start_from',
]
