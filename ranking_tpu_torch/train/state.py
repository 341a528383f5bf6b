"""Training state: the model, its optimizers and the step count.

The port's counterpart of ``ranking_tpu/train/state.py``. The JAX package
threads one immutable pytree (params, batch statistics, optimizer state,
step) through pure step functions; here the parameters and the batch
statistics live in the ``nn.Module`` and the moments in the
``torch.optim.Optimizer``, and a train step updates both in place. With a
``sparse_tx`` (``train.sparse.LazyAdam`` or ``LazyAdagrad``) the embedding
tables leave the optimizer: the sparse train step steps their touched rows
and keeps their moments in ``sparse_opt_state``, beside the tables.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Optional

import torch
from torch import nn

from ranking_tpu_torch.train import sparse as sparse_lib
from ranking_tpu_torch.utils.device import DeviceLike, resolve_device

OptimizerFactory = Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer]


def adam(learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> OptimizerFactory:
  """``optax.adam`` as a ``torch.optim.Adam`` factory: bias-corrected
  moments, eps added outside the root, no weight decay."""
  return lambda params: torch.optim.Adam(params, lr=learning_rate,
                                         betas=(b1, b2), eps=eps)


class _OptaxAdagrad(torch.optim.Optimizer):
  """``optax.adagrad``: the accumulator starts at
  ``initial_accumulator_value`` and the update is ``lr * g * rsqrt(acc +
  eps)`` where ``acc > 0``, else 0. (``torch.optim.Adagrad`` starts from 0
  and divides by ``sqrt(acc) + eps``.)"""

  def __init__(self, params, lr: float, initial: float, eps: float):
    super().__init__(params, dict(lr=lr, initial=initial, eps=eps))

  @torch.no_grad()
  def step(self, closure=None):
    for group in self.param_groups:
      for p in group['params']:
        if p.grad is None:
          continue
        state = self.state[p]
        if not state:
          state['sum_of_squares'] = torch.full_like(p, group['initial'])
        acc = state['sum_of_squares']
        acc.copy_(p.grad * p.grad + acc)
        inv = torch.where(acc > 0, torch.rsqrt(acc + group['eps']), 0.0)
        p.add_((inv * p.grad) * -group['lr'])


def adagrad(learning_rate: float = 1e-3,
            initial_accumulator_value: float = 0.1,
            eps: float = 1e-7) -> OptimizerFactory:
  """``optax.adagrad`` as an optimizer factory."""
  return lambda params: _OptaxAdagrad(params, learning_rate,
                                      initial_accumulator_value, eps)


@dataclasses.dataclass
class TrainState:
  """Everything that evolves during training. ``sparse_tx`` and
  ``sparse_opt_state``: the lazy-row optimizer of the embedding tables and
  its state (``{path: moments, 'count', 'dropped'}``), or None."""

  model: nn.Module
  optimizer: torch.optim.Optimizer
  step: int = 0
  sparse_tx: Optional[Any] = None
  sparse_opt_state: Optional[dict] = None

  @property
  def device(self) -> torch.device:
    return next(self.model.parameters()).device


def create_train_state(
    model: nn.Module,
    optimizer: Optional[OptimizerFactory] = None,
    device: DeviceLike = 'cuda',
    sparse_tx: Optional[Any] = None,
) -> TrainState:
  """Moves ``model`` to ``device`` and builds its optimizers there.

  ``optimizer`` maps the model's parameters to a ``torch.optim.Optimizer``
  (default ``adam(1e-3)``). It is built after the move, so its state lives
  beside the parameters. ``sparse_tx`` (``train.sparse.LazyAdam`` or
  ``LazyAdagrad``) takes the parameters whose '/'-joined path matches its
  table pattern out of ``optimizer`` and into the lazy-row update.
  """
  device = resolve_device(device)
  model = model.to(device)
  factory = adam() if optimizer is None else optimizer
  if sparse_tx is None:
    return TrainState(model=model, optimizer=factory(model.parameters()))
  dense, tables = sparse_lib.partition(sparse_lib.named_paths(model),
                                       sparse_tx)
  return TrainState(
      model=model,
      optimizer=factory([p for p in dense.values() if p is not None]),
      sparse_tx=sparse_tx, sparse_opt_state=sparse_tx.init(tables))
