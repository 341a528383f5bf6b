"""Training state: the model, its optimizer and the step count.

The port's counterpart of ``ranking_tpu/train/state.py``. The JAX package
threads one immutable pytree (params, batch statistics, optimizer state,
step) through pure step functions; here the parameters and the batch
statistics live in the ``nn.Module`` and the moments in the
``torch.optim.Optimizer``, and a train step updates both in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional

import torch
from torch import nn

from ranking_tpu_torch.utils.device import DeviceLike, resolve_device

OptimizerFactory = Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer]


def adam(learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> OptimizerFactory:
  """``optax.adam`` as a ``torch.optim.Adam`` factory: bias-corrected
  moments, eps added outside the root, no weight decay."""
  return lambda params: torch.optim.Adam(params, lr=learning_rate,
                                         betas=(b1, b2), eps=eps)


@dataclasses.dataclass
class TrainState:
  """Everything that evolves during training."""

  model: nn.Module
  optimizer: torch.optim.Optimizer
  step: int = 0

  @property
  def device(self) -> torch.device:
    return next(self.model.parameters()).device


def create_train_state(
    model: nn.Module,
    optimizer: Optional[OptimizerFactory] = None,
    device: DeviceLike = 'cuda',
) -> TrainState:
  """Moves ``model`` to ``device`` and builds its optimizer there.

  ``optimizer`` maps the model's parameters to a ``torch.optim.Optimizer``
  (default ``adam(1e-3)``). It is built after the move, so its state lives
  beside the parameters.
  """
  device = resolve_device(device)
  model = model.to(device)
  factory = adam() if optimizer is None else optimizer
  return TrainState(model=model, optimizer=factory(model.parameters()))
