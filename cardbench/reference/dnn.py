"""The feed-forward scorer with batch normalization, plain PyTorch
(TF-Ranking's DNN scorer, keras/model.py: features -> [Dense -> BN -> ReLU]*
-> Dense(1), each document scored on its own).

Weights: ``{'w0', 'b0', 'gamma0', 'beta0', 'mean0', 'var0', ..., 'w_out',
'b_out'}``, ``w_l`` as ``[out, in]``. In training the batch statistics are
the mean and (biased) variance over the valid documents only; in eval the
stored ``mean_l`` and ``var_l``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from cardbench.reference import ranking

Tensor = torch.Tensor
PADDING_LOGIT = math.log(1e-10)


def forward(w: Dict[str, Tensor], features: Tensor, valid: Tensor,
            training: bool, eps: float = 1e-5,
            stats: Optional[Dict[str, Tensor]] = None) -> Tensor:
  """``features [B, L, F]``, ``valid [B, L]`` -> logits ``[B, L]``, absent
  documents at log(1e-10). In training, ``stats`` (a dict) receives each
  layer's batch mean as ``mean<l>``."""
  b, l, f = features.shape
  x = ranking.log1p_features(features).reshape(b * l, f)
  m = valid.reshape(b * l, 1).to(x.dtype)
  n = torch.clamp(m.sum(), min=1.0)
  layer = 0
  while f'w{layer}' in w:
    y = x @ w[f'w{layer}'].t() + w[f'b{layer}']
    if training:
      mean = (y * m).sum(0) / n
      var = torch.clamp((y * y * m).sum(0) / n - mean * mean, min=0.0)
      if stats is not None:
        stats[f'mean{layer}'] = mean.detach()
    else:
      mean, var = w[f'mean{layer}'], w[f'var{layer}']
    x = torch.relu((y - mean) * torch.rsqrt(var + eps) * w[f'gamma{layer}']
                   + w[f'beta{layer}'])
    layer += 1
  out = (x @ w['w_out'].t() + w['b_out']).reshape(b, l)
  return torch.where(valid, out, torch.full_like(out, PADDING_LOGIT))
