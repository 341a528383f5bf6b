"""Training steps by autograd over a dict of leaves, with optax's Adagrad and
Adam (optax/_src/alias.py), plain PyTorch.

``steps(loss_of, weights, trainable, batches, optimizer)`` runs one step a
batch from ``weights`` and returns each step's loss and logits' mean and
root mean square, the first step's gradients and the trained leaves.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Sequence

import torch

Tensor = torch.Tensor


class Adagrad:
  """optax.adagrad: ``acc += g^2``; ``p -= lr g / sqrt(acc + eps)`` where
  ``acc > 0``."""

  def __init__(self, learning_rate: float, initial_accumulator_value: float,
               eps: float):
    self.lr, self.initial, self.eps = (learning_rate,
                                       initial_accumulator_value, eps)
    self.acc: Dict[str, Tensor] = {}

  def update(self, name: str, p: Tensor, g: Tensor) -> Tensor:
    acc = self.acc.get(name)
    if acc is None:
      acc = torch.full_like(p, self.initial)
    acc = acc + g * g
    self.acc[name] = acc
    step = torch.where(acc > 0, g / torch.sqrt(acc + self.eps),
                       torch.zeros_like(g))
    return p - self.lr * step


class Adam:
  """optax.adam: bias-corrected moments, ``eps`` outside the root."""

  def __init__(self, learning_rate: float, b1: float, b2: float, eps: float):
    self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
    self.m: Dict[str, Tensor] = {}
    self.v: Dict[str, Tensor] = {}
    self.t: Dict[str, int] = {}

  def update(self, name: str, p: Tensor, g: Tensor) -> Tensor:
    t = self.t.get(name, 0) + 1
    m = self.b1 * self.m.get(name, torch.zeros_like(p)) + (1 - self.b1) * g
    v = self.b2 * self.v.get(name, torch.zeros_like(p)) + (1 - self.b2) * g * g
    self.m[name], self.v[name], self.t[name] = m, v, t
    m_hat = m / (1 - self.b1 ** t)
    v_hat = v / (1 - self.b2 ** t)
    return p - self.lr * m_hat / (torch.sqrt(v_hat) + self.eps)


def make_optimizer(spec: Mapping):
  """The optimizer a traffic mix names: ``{'name': 'adagrad' | 'adam',
  ...its hyperparameters}``."""
  kw = {k: v for k, v in spec.items() if k != 'name'}
  return {'adagrad': Adagrad, 'adam': Adam}[spec['name']](**kw)


def steps(loss_of: Callable[[Dict[str, Tensor], object], tuple],
          weights: Mapping[str, Tensor], trainable: Sequence[str],
          batches: Sequence[object], optimizer):
  """``(losses, logits, first_grads, trained)``: one step a batch;
  ``loss_of(w, batch)`` gives the scalar loss of leaves ``w``, the logits
  and their validity; ``logits`` holds each step's (mean, root mean
  square) of the valid logits."""
  w = {k: v.detach().clone() for k, v in weights.items()}
  losses: List[float] = []
  logit_stats: List[tuple] = []
  first: Dict[str, Tensor] = {}
  for i, batch in enumerate(batches):
    leaves = {k: w[k].detach().requires_grad_(True) for k in trainable}
    loss, logits, valid = loss_of({**w, **leaves}, batch)
    grads = torch.autograd.grad(loss, [leaves[k] for k in trainable])
    losses.append(float(loss.detach()))
    v = logits.detach()[valid].double()
    logit_stats.append((float(v.mean()), float(torch.sqrt((v * v).mean()))))
    with torch.no_grad():
      for k, g in zip(trainable, grads):
        if i == 0:
          first[k] = g.detach().clone()
        w[k] = optimizer.update(k, w[k], g)
  return losses, logit_stats, first, {k: w[k] for k in trainable}
