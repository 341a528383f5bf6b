"""TF-Ranking's losses and NDCG, plain PyTorch (tensorflow_ranking/python/
losses_impl.py and metrics_impl.py).

Labels are ``[B, L]`` with -1 at absent documents; logits ``[B, L]``.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def log1p_features(x: Tensor) -> Tensor:
  """sign(x) log(1 + |x|) (keras/model.py's 'log1p' transform)."""
  return torch.sign(x) * torch.log1p(torch.abs(x))


def _gain(labels: Tensor) -> Tensor:
  return torch.pow(2.0, labels) - 1.0


def _log2_discount(rank: Tensor) -> Tensor:
  return math.log(2.0) / torch.log1p(rank)


def ranks(logits: Tensor, valid: Tensor) -> Tensor:
  """1-based ranks of the valid documents by descending logit (ties by
  position); absent documents after them."""
  b, l = logits.shape
  pos = torch.arange(l, device=logits.device)
  key_gt = logits[:, None, :] > logits[:, :, None]
  key_eq = (logits[:, None, :] == logits[:, :, None]) & (pos[None, :] < pos[:, None])[None]
  ahead = (key_gt | key_eq) & valid[:, None, :]
  r = 1 + ahead.sum(-1)
  n_valid = valid.sum(-1, keepdim=True)
  invalid_rank = n_valid + 1 + torch.cumsum((~valid).long(), -1) - 1
  return torch.where(valid, r, invalid_rank).to(logits.dtype)


def inverse_max_dcg(labels: Tensor, valid: Tensor) -> Tensor:
  """``[B, 1]`` 1 / ideal DCG (gain 2^l - 1, log2 discount), 0 where it is
  0; absent documents count label 0."""
  clean = torch.where(valid, labels, torch.zeros_like(labels))
  ideal = torch.sort(clean, dim=1, descending=True).values
  r = torch.arange(1, labels.shape[1] + 1, device=labels.device,
                   dtype=labels.dtype)
  dcg = (_gain(ideal) * _log2_discount(r)).sum(1, keepdim=True)
  return torch.where(dcg > 0, 1.0 / dcg, torch.zeros_like(dcg))


def pairwise_logistic_ndcg_loss(labels: Tensor, logits: Tensor) -> Tensor:
  """``pairwise_logistic_loss`` under the normalized NDCG lambda weight of
  LambdaLoss (``DCGLambdaWeightV2``, gain 2^l - 1, log2 discount, topn the
  list size), reduced by the sum over the number of non-zero weights.

  Each pair (i, j) with l_i > l_j of valid documents has loss
  log(1 + exp(-(s_i - s_j))) and weight L |G_i - G_j| |D(k) - D(k + 1)|
  for k = |rank_i - rank_j|, G the gains over the ideal DCG."""
  valid = labels >= 0
  lab = torch.where(valid, labels, torch.zeros_like(labels))
  r = ranks(logits.detach(), valid)
  g = _gain(lab) * inverse_max_dcg(labels, valid)
  pair_valid = valid[:, :, None] & valid[:, None, :]
  prefer = (lab[:, :, None] > lab[:, None, :]) & pair_valid
  k = torch.abs(r[:, :, None] - r[:, None, :])
  disc = torch.abs(_log2_discount(torch.clamp(k, min=1e-12))
                   - _log2_discount(k + 1.0))
  w = (torch.abs(g[:, :, None] - g[:, None, :]) * torch.where(k > 0, disc, 0.0)
       * labels.shape[1])
  w = torch.where(prefer, w, torch.zeros_like(w))
  diff = logits[:, :, None] - logits[:, None, :]
  loss = torch.clamp(-diff, min=0.0) + torch.log1p(torch.exp(-torch.abs(diff)))
  n = (w != 0).sum().to(logits.dtype)
  return torch.where(n > 0, (loss * w).sum() / torch.clamp(n, min=1.0),
                     torch.zeros((), dtype=logits.dtype, device=logits.device))


def softmax_loss(labels: Tensor, logits: Tensor) -> Tensor:
  """ListNet's softmax cross entropy: each list's label distribution (a
  uniform 1e-10 over its valid documents where its labels sum to 0)
  against the softmax of its logits over the valid documents, weighted by
  the list's label sum and reduced by the sum over the number of lists of
  non-zero weight."""
  valid = labels >= 0
  lab = torch.where(valid, labels, torch.zeros_like(labels))
  logits = torch.where(valid, logits, torch.full_like(logits, math.log(1e-10)))
  label_sum = lab.sum(1, keepdim=True)
  padded = torch.where(label_sum > 0, lab, torch.full_like(lab, 1e-10))
  padded = torch.where(valid, padded, torch.zeros_like(padded))
  dist = padded / torch.clamp(padded.sum(1, keepdim=True), min=1e-38)
  per_list = -(dist * torch.log_softmax(logits, dim=1)).sum(1)
  w = label_sum.reshape(-1)
  n = (w != 0).sum().to(logits.dtype)
  return torch.where(n > 0, (per_list * w).sum() / torch.clamp(n, min=1.0),
                     torch.zeros((), dtype=logits.dtype, device=logits.device))
