"""The BERT encoder scorer (TFR-BERT): the program's
``RankingModel(EncoderScorer(TransformerEncoder(...)))``, its weights,
inputs and work, and its plain reference (``cardbench/reference/encoder.py``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from cardbench import synth, work
from cardbench.reference import encoder as ref_encoder

Tensor = torch.Tensor
FEATURES = ('input_ids', 'input_mask', 'segment_ids')
PADDING_LOGIT = float(np.log(1e-10))


def _shapes(config) -> Dict[str, tuple]:
  """Every weight's shape, in the reference's names and layouts."""
  h, f = config['hidden_size'], config['intermediate_size']
  s = {'tok': (config['vocab_size'], h),
       'pos': (config['max_position_embeddings'], h),
       'type': (config['type_vocab_size'], h), 'ln_s': (h,), 'ln_b': (h,)}
  for i in range(config['num_hidden_layers']):
    for n in ('q', 'k', 'v', 'o'):
      s[f'{i}.{n}'], s[f'{i}.{n}_b'] = (h, h), (h,)
    s[f'{i}.ln1_s'], s[f'{i}.ln1_b'] = (h,), (h,)
    s[f'{i}.mlp0'], s[f'{i}.mlp0_b'] = (h, f), (f,)
    s[f'{i}.mlp1'], s[f'{i}.mlp1_b'] = (f, h), (h,)
    s[f'{i}.ln2_s'], s[f'{i}.ln2_b'] = (h,), (h,)
  s['pool'], s['pool_b'] = (h, h), (h,)
  s['score'], s['score_b'] = (h, 1), (1,)
  return s


def draw_weights(config, seed: int, device) -> Dict[str, Tensor]:
  """Every matrix and table from one draw of normals on the device, scaled
  by ``initializer_range`` and clipped at two standard deviations; zero
  biases, unit LayerNorm scales."""
  shapes = _shapes(config)
  mats = [n for n, sh in shapes.items() if len(sh) == 2]
  gen = torch.Generator(device).manual_seed(int(seed) % 2**63)
  flat = torch.randn(sum(int(np.prod(shapes[n])) for n in mats),
                     generator=gen, device=device)
  flat = flat.clamp_(-2.0, 2.0).mul_(config['initializer_range'])
  w, at = {}, 0
  for n in mats:
    size = int(np.prod(shapes[n]))
    w[n] = flat[at:at + size].reshape(shapes[n])
    at += size
  for n, sh in shapes.items():
    if len(sh) == 1:
      ones = n.endswith('_s')
      w[n] = (torch.ones if ones else torch.zeros)(sh, device=device)
  return w


def trainable(config) -> List[str]:
  return list(_shapes(config))


def _port_names(config) -> Dict[str, str]:
  e = 'scorer.encoder.'
  out = {e + 'token_embed.embedding': 'tok', e + 'pos_embed.embedding': 'pos',
         e + 'type_embed.embedding': 'type', e + 'LayerNorm_0.scale': 'ln_s',
         e + 'LayerNorm_0.bias': 'ln_b', e + 'pooler.kernel': 'pool',
         e + 'pooler.bias': 'pool_b', 'scorer.score.kernel': 'score',
         'scorer.score.bias': 'score_b'}
  for i in range(config['num_hidden_layers']):
    b = f'{e}block_{i}.'
    a = b + 'MultiHeadDotProductAttention_0.'
    for port, ref in (('query', 'q'), ('key', 'k'), ('value', 'v'),
                      ('out', 'o')):
      out[f'{a}{port}.kernel'] = f'{i}.{ref}'
      out[f'{a}{port}.bias'] = f'{i}.{ref}_b'
    for port, ref in (('LayerNorm_0', 'ln1'), ('LayerNorm_1', 'ln2')):
      out[f'{b}{port}.scale'] = f'{i}.{ref}_s'
      out[f'{b}{port}.bias'] = f'{i}.{ref}_b'
    for port, ref in (('Dense_0', 'mlp0'), ('Dense_1', 'mlp1')):
      out[f'{b}{port}.kernel'] = f'{i}.{ref}'
      out[f'{b}{port}.bias'] = f'{i}.{ref}_b'
  return out


def build(config, weights: Dict[str, Tensor], device):
  """The program's model on ``device``, holding a copy of ``weights``."""
  from ranking_tpu_torch.models import encoder, scorers
  if config['hidden_act'] != 'gelu':
    raise ValueError(f"hidden_act {config['hidden_act']!r}: the encoder "
                     'computes gelu')
  if config['attention_probs_dropout_prob'] != config['hidden_dropout_prob']:
    raise ValueError('the encoder takes one dropout rate')
  with torch.device('meta'):
    enc = encoder.TransformerEncoder(
        config['vocab_size'], config['hidden_size'],
        config['num_hidden_layers'], config['num_attention_heads'],
        config['intermediate_size'], config['max_position_embeddings'],
        type_vocab_size=config['type_vocab_size'],
        dropout=config['attention_probs_dropout_prob'])
    model = scorers.RankingModel(encoder.EncoderScorer(
        enc, dropout=config['hidden_dropout_prob']))
  model = model.to_empty(device=device)
  names = _port_names(config)
  params = dict(model.named_parameters())
  if set(params) != set(names):
    raise ValueError(f'unmapped parameters: {sorted(set(params) ^ set(names))}')
  with torch.no_grad():
    for port, p in params.items():
      p.copy_(weights[names[port]].reshape(p.shape))
  return model


def leaf_params(config, model) -> Dict[str, Tensor]:
  params = dict(model.named_parameters())
  return {leaf: params[port] for port, leaf in _port_names(config).items()}


# -- inputs ------------------------------------------------------------------


def make_lists(config, traffic, seed: int, num_lists: int, docs=None):
  """``({feature: [Q, L, T]}, labels [Q, L])``: ``docs[i]`` documents in
  list i (default: the traffic's ``min_docs..max_docs`` in turn)."""
  if docs is None:
    docs = synth.doc_counts(synth.rng(seed, 3), num_lists,
                            traffic['min_docs'], traffic['max_docs'])
  ids, mask, seg, labels = synth.bert_lists(
      seed, num_lists, np.asarray(docs), traffic['list_size'],
      traffic['seq_len'], traffic['min_tokens'], traffic['max_tokens'],
      config['vocab_size'])
  return dict(zip(FEATURES, (ids, mask, seg))), labels


def _tokens(examples, labels: np.ndarray) -> np.ndarray:
  """Valid tokens of each valid document."""
  return np.asarray(examples['input_mask']).sum(-1)[labels >= 0]


def _widths(config):
  return (config['hidden_size'], config['intermediate_size'],
          config['num_hidden_layers'])


def train_flops(config, examples, labels: np.ndarray) -> float:
  return work.encoder_train_flops(_tokens(examples, labels), *_widths(config))


def forward_flops(config, examples, labels: np.ndarray) -> float:
  return work.encoder_forward_flops(_tokens(examples, labels),
                                    *_widths(config))


def running_means(config, model) -> Dict[str, Tensor]:
  """No running statistics: the encoder normalizes by layer."""
  return {}


def reference_logits(config, w, examples: Dict[str, Tensor], labels: Tensor,
                     training: bool, stats=None) -> Tensor:
  """``[B, L]`` logits of ``[B, L, T]`` inputs (dropout 0: training and
  eval agree); absent documents at log(1e-10). No running statistics to
  put in ``stats``."""
  del training, stats
  b, l, t = examples['input_ids'].shape
  valid = (labels >= 0).reshape(-1)
  flat = {k: examples[k].reshape(b * l, t)[valid] for k in FEATURES}
  s = ref_encoder.scores(w, flat['input_ids'], flat['input_mask'],
                         flat['segment_ids'], config['num_hidden_layers'],
                         config['num_attention_heads'])
  out = torch.full((b * l,), PADDING_LOGIT, dtype=s.dtype, device=s.device)
  out[valid] = s
  return out.reshape(b, l)


def reference_scores(config, w, examples: Dict[str, Tensor]) -> Tensor:
  """``[N]`` scores of ``N`` documents' ``[N, T]`` inputs."""
  return ref_encoder.scores(w, examples['input_ids'], examples['input_mask'],
                            examples['segment_ids'],
                            config['num_hidden_layers'],
                            config['num_attention_heads'])
