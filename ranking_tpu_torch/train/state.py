"""Training state: the model, its optimizers and the step count.

The port's counterpart of ``ranking_tpu/train/state.py``. The JAX package
threads one immutable pytree (params, batch statistics, optimizer state,
step) through pure step functions; here the parameters and the batch
statistics live in the ``nn.Module`` and the moments in the
``torch.optim.Optimizer``, and a train step updates both in place. With a
``sparse_tx`` (``train.sparse.LazyAdam`` or ``LazyAdagrad``) the embedding
tables leave the optimizer: the sparse train step steps their touched rows
and keeps their moments in ``sparse_opt_state``, beside the tables; the
plain train step hands their dense gradients to ``sparse_tx.update``
(``TrainState.apply_gradients``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Optional, Sequence, Union

import torch
from torch import nn

from ranking_tpu_torch.train import sparse as sparse_lib
from ranking_tpu_torch.utils.device import DeviceLike, resolve_device

Tensor = torch.Tensor

OptimizerFactory = Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer]
# A learning rate: a float, or optax's kind of schedule, a function of the
# 0-based count of updates (here an int32 tensor on the device) to the rate.
Schedule = Callable[[Tensor], Tensor]
LearningRate = Union[float, Schedule]


class _OptaxHooks:
  """What optax chains around an update, for a ``torch.optim`` optimizer.

  Mixed in front of the optimizer's class. The learning rate is a 0-d
  float32 tensor beside the parameters (``self.lr``, every param group's
  ``'lr'``), so that one captured CUDA graph serves every step: a schedule
  is evaluated inside ``step`` from ``self.count``, the int32 count of
  updates on the device (optax's ``ScaleByScheduleState.count``), and the
  plateau hook scales ``self.lr`` in place between steps. With
  ``clip_norm`` the gradients are first clipped as
  ``optax.clip_by_global_norm`` clips them. Nothing reads a value back to
  the host.
  """

  def _init_hooks(self, lr: Tensor, schedule: Optional[Schedule],
                  clip_norm: Optional[float]) -> None:
    self.lr = lr
    self.count = torch.zeros((), dtype=torch.int32, device=lr.device)
    self.schedule = schedule
    self.clip_norm = clip_norm
    # Eager steps of a capturable optimizer are intended here (the warm-up
    # before a capture, the CPU-free yardstick): no warning about them.
    self._warned_capturable_if_run_uncaptured = True

  @torch.no_grad()
  def step(self, closure=None):
    if self.clip_norm is not None:
      params = [p for group in self.param_groups for p in group['params']
                if p.grad is not None]
      mesh = getattr(self, 'mesh', None)
      sharded = None
      if mesh is not None and mesh.model_group is not None:
        sharded = ([p.grad for p in params if id(p) in self.sharded_grads],
                   mesh.model_group)
      clip_by_global_norm_([p.grad for p in params], self.clip_norm,
                           sharded)
    if self.schedule is not None:
      self.lr.copy_(self.schedule(self.count))
    out = super().step(closure)
    self.count.add_(1)
    return out

  def __getstate__(self):  # torch.optim keeps only its own three fields
    out = super().__getstate__()
    out.update(lr=self.lr, count=self.count, schedule=self.schedule,
               clip_norm=self.clip_norm,
               _warned_capturable_if_run_uncaptured=True)
    return out

  def state_dict(self):
    out = super().state_dict()
    out['count'] = self.count.clone()
    return out

  def load_state_dict(self, state_dict):
    state_dict = dict(state_dict)
    count = state_dict.pop('count')
    super().load_state_dict(state_dict)
    # The loaded groups hold copies of the rate; the step (and a graph that
    # captured it) reads self.lr, which takes their value.
    self.lr.copy_(self.param_groups[0]['lr'])
    for group in self.param_groups:
      group['lr'] = self.lr
    self.count.copy_(count)


def clip_by_global_norm_(grads: Sequence[Tensor], max_norm: float,
                         sharded=None) -> None:
  """``optax.clip_by_global_norm``, in place: with ``norm`` the square root
  of the sum over ``grads`` (in their order) of each one's sum of squares,
  each gradient becomes ``where(norm < max_norm, g, g / norm * max_norm)``.
  (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``.)
  ``sharded``: ``(grads, group)``, those of ``grads`` that are a rank's
  slices over a model group, whose squares are summed over the group."""
  if not grads:
    return
  if sharded is None or not sharded[0]:
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
  else:
    from ranking_tpu_torch.parallel import comm
    ids = {id(g) for g in sharded[0]}
    whole = sum(torch.sum(g * g) for g in grads if id(g) not in ids)
    split = comm.all_reduce(sum(torch.sum(g * g) for g in sharded[0]),
                            sharded[1])
    norm = torch.sqrt(whole + split)
  keep = norm < max_norm
  for g in grads:
    g.copy_(torch.where(keep, g, g / norm * max_norm))


def _build(cls, params, learning_rate: LearningRate,
           clip_norm: Optional[float], **kwargs) -> torch.optim.Optimizer:
  params = list(params)
  device = params[0].device if params else torch.device('cpu')
  schedule = learning_rate if callable(learning_rate) else None
  # A schedule's first value stands in until the first step sets it.
  start = (schedule(torch.zeros((), dtype=torch.int32)) if schedule
           else learning_rate)
  lr = torch.tensor(float(start), dtype=torch.float32, device=device)
  if device.type == 'cuda' and cls in (Adam, AdamW):
    kwargs['capturable'] = True
  opt = cls(params, lr=lr, **kwargs)
  opt._init_hooks(lr, schedule, clip_norm)
  return opt


class Adam(_OptaxHooks, torch.optim.Adam):
  """``torch.optim.Adam`` with the hooks; capturable on CUDA, so that its
  step counts stay on the device and the same update runs eagerly and
  inside a CUDA graph."""


class AdamW(_OptaxHooks, torch.optim.AdamW):
  """``torch.optim.AdamW`` with the hooks; capturable on CUDA."""


class _SGDUpdate(torch.optim.Optimizer):

  def __init__(self, params, lr: Tensor):
    super().__init__(params, dict(lr=lr))

  @torch.no_grad()
  def step(self, closure=None):
    for group in self.param_groups:
      for p in group['params']:
        if p.grad is not None:
          p.add_(p.grad * -group['lr'])


class _AdagradUpdate(torch.optim.Optimizer):

  def __init__(self, params, lr: Tensor, initial: float, eps: float):
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


class SGD(_OptaxHooks, _SGDUpdate):
  """``optax.sgd`` without momentum: ``p + g * -lr``."""


class Adagrad(_OptaxHooks, _AdagradUpdate):
  """``optax.adagrad``: the accumulator starts at
  ``initial_accumulator_value`` and the update is ``lr * g * rsqrt(acc +
  eps)`` where ``acc > 0``, else 0. (``torch.optim.Adagrad`` starts from 0
  and divides by ``sqrt(acc) + eps``.)"""


def adam(learning_rate: LearningRate = 1e-3, b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8,
         clip_norm: Optional[float] = None) -> OptimizerFactory:
  """``optax.adam`` as an optimizer factory: bias-corrected moments, eps
  added outside the root, no weight decay."""
  return lambda params: _build(Adam, params, learning_rate, clip_norm,
                               betas=(b1, b2), eps=eps)


def adamw(learning_rate: LearningRate = 1e-3, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 1e-4,
          clip_norm: Optional[float] = None) -> OptimizerFactory:
  """``optax.adamw``: Adam plus ``weight_decay * p`` on every parameter,
  scaled by the learning rate. optax's default decay is 1e-4
  (``torch.optim.AdamW``'s 1e-2)."""
  return lambda params: _build(AdamW, params, learning_rate, clip_norm,
                               betas=(b1, b2), eps=eps,
                               weight_decay=weight_decay)


def sgd(learning_rate: LearningRate = 1e-3,
        clip_norm: Optional[float] = None) -> OptimizerFactory:
  """``optax.sgd`` (no momentum) as an optimizer factory."""
  return lambda params: _build(SGD, params, learning_rate, clip_norm)


def adagrad(learning_rate: LearningRate = 1e-3,
            initial_accumulator_value: float = 0.1,
            eps: float = 1e-7,
            clip_norm: Optional[float] = None) -> OptimizerFactory:
  """``optax.adagrad`` as an optimizer factory."""
  return lambda params: _build(Adagrad, params, learning_rate, clip_norm,
                               initial=initial_accumulator_value, eps=eps)


@dataclasses.dataclass
class TrainState:
  """Everything that evolves during training. ``sparse_tx`` and
  ``sparse_opt_state``: the lazy-row optimizer of the embedding tables and
  its state (``{path: moments, 'count', 'dropped'}``), or None.
  ``generator``: the steps' random stream where a caller keeps one with the
  state (the pipeline does, and checkpoints it), or None."""

  model: nn.Module
  optimizer: torch.optim.Optimizer
  step: int = 0
  sparse_tx: Optional[Any] = None
  sparse_opt_state: Optional[dict] = None
  generator: Optional[torch.Generator] = None

  @property
  def device(self) -> torch.device:
    return next(self.model.parameters()).device

  def _tables(self) -> dict:
    return sparse_lib.partition(sparse_lib.named_paths(self.model),
                                self.sparse_tx)[1]

  def zero_grad(self) -> None:
    """Drops every parameter's gradient, the tables' too."""
    self.optimizer.zero_grad(set_to_none=True)
    if self.sparse_tx is not None:
      for table in self._tables().values():
        table.grad = None

  def apply_gradients(self) -> None:
    """One update from the gradients in the parameters' ``.grad``, in
    place (the JAX package's ``apply_gradients``): the dense optimizer
    steps its parameters; with a ``sparse_tx`` the tables, which the dense
    optimizer does not hold, go to ``sparse_tx.update`` with their dense
    gradients (a table the loss did not reach has none and keeps its
    state). ``step`` is the caller's to advance."""
    self.optimizer.step()
    if self.sparse_tx is not None:
      tables = self._tables()
      grads = {p: t.grad for p, t in tables.items() if t.grad is not None}
      self.sparse_tx.update(grads, self.sparse_opt_state, tables)


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
