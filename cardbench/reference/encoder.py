"""BERT's encoder and the TFR-BERT score head, plain PyTorch (Devlin et al.,
google-research/bert modeling.py; Han et al., arXiv:2004.08476).

Token, position and segment embeddings, LayerNorm; per layer: multi-head
self-attention over the document's valid tokens, residual, LayerNorm, a
tanh-approximated GELU MLP, residual, LayerNorm (post-LN); the pooled
``tanh(dense(h[CLS]))`` and one dense unit as the score. Departures from
BERT's code, as the configuration states them: LayerNorm epsilon 1e-6 and
dropout 0.

Weights (names as in ``cardbench/families/encoder.py``): ``tok``, ``pos``,
``type`` tables; ``ln_s``, ``ln_b``; per layer ``i``: ``{i}.q``, ``{i}.k``,
``{i}.v`` ``[H, H]`` with biases ``{i}.q_b``...; ``{i}.o``, ``{i}.o_b``;
``{i}.ln1_s``, ``{i}.ln1_b``; ``{i}.mlp0`` ``[H, F]``, ``{i}.mlp0_b``,
``{i}.mlp1`` ``[F, H]``, ``{i}.mlp1_b``; ``{i}.ln2_s``, ``{i}.ln2_b``;
``pool``, ``pool_b``, ``score`` ``[H, 1]``, ``score_b``. Products are
``x @ W``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _layer_norm(x: Tensor, scale: Tensor, bias: Tensor, eps: float) -> Tensor:
  mean = x.mean(-1, keepdim=True)
  var = ((x - mean) ** 2).mean(-1, keepdim=True)
  return (x - mean) / torch.sqrt(var + eps) * scale + bias


def scores(w: Dict[str, Tensor], ids: Tensor, input_mask: Tensor,
           segment_ids: Tensor, num_layers: int, num_heads: int,
           eps: float = 1e-6) -> Tensor:
  """``ids``, ``input_mask``, ``segment_ids`` ``[N, T]`` -> ``[N]`` scores."""
  n, t = ids.shape
  valid = input_mask > 0
  x = (w['tok'][torch.where(valid, ids, 0)] + w['pos'][:t][None]
       + w['type'][torch.where(valid, segment_ids, 0)])
  x = _layer_norm(x, w['ln_s'], w['ln_b'], eps) * valid[..., None]
  hidden = x.shape[-1]
  d = hidden // num_heads
  key_mask = valid[:, None, None, :]
  for i in range(num_layers):
    def heads(name):
      return (x @ w[f'{i}.{name}'] + w[f'{i}.{name}_b']).reshape(
          n, t, num_heads, d).transpose(1, 2)
    q, k, v = heads('q'), heads('k'), heads('v')
    logits = (q / math.sqrt(d)) @ k.transpose(-1, -2)
    logits = logits.masked_fill(~key_mask, torch.finfo(logits.dtype).min)
    att = torch.softmax(logits, -1) @ v
    y = att.transpose(1, 2).reshape(n, t, hidden) @ w[f'{i}.o'] + w[f'{i}.o_b']
    x = _layer_norm(x + y, w[f'{i}.ln1_s'], w[f'{i}.ln1_b'], eps)
    y = F.gelu(x @ w[f'{i}.mlp0'] + w[f'{i}.mlp0_b'], approximate='tanh')
    y = y @ w[f'{i}.mlp1'] + w[f'{i}.mlp1_b']
    x = _layer_norm(x + y, w[f'{i}.ln2_s'], w[f'{i}.ln2_b'], eps)
  pooled = torch.tanh(x[:, 0] @ w['pool'] + w['pool_b'])
  return (pooled @ w['score'] + w['score_b']).reshape(n)
