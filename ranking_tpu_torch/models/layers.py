"""Ranking model layers: feature concatenation, list restore, scoring tower.

The port's copy of the inference parts of ``ranking_tpu/models/layers.py``
(the reference's tensorflow_ranking/python/keras/layers.py). The data model
is the framework's: context features ``[B, ...]``, example features
``[B, L, ...]``, a boolean ``mask [B, L]``.

Only the eval path is ported: ``training=True`` raises. The parameter
layout (a Linear and a BatchNorm1d per hidden layer, named initializers)
is the one the training slice will train.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ranking_tpu_torch.utils import list_ops

Tensor = torch.Tensor

# Score of a padded slot; the JAX package's restore_list fill.
PADDING_LOGIT = math.log(1e-10)

TRAINING_NOT_PORTED = (
    'training=True is not ported yet: the PyTorch port serves and '
    'evaluates; the train path (masked-BN tower kernels, losses, Adam) is '
    'the next slice')


def restore_list(flat_logits: Tensor, mask: Tensor) -> Tensor:
  """Restores ``[B*L, 1]`` (or ``[B*L]``) scores to masked ``[B, L]``
  logits; invalid entries become ``log(1e-10)``."""
  batch, list_size = mask.shape
  logits = flat_logits.reshape(batch, list_size)
  return torch.where(mask, logits, PADDING_LOGIT)


def concat_features(
    context_features: Dict[str, Tensor],
    example_features: Dict[str, Tensor],
    mask: Tensor,
    circular_padding: bool = True,
) -> Tensor:
  """Concatenates all features into one ``[B, L, sum(F)]`` float tensor.

  Context features are broadcast over the list axis, 2-D example features
  get a trailing feature axis, and features go in name order within each
  group (keras/layers.py:276-375). With ``circular_padding`` invalid slots
  take valid examples of the same list.
  """
  batch, list_size = mask.shape

  def _as_3d(tensor: Tensor) -> Tensor:
    if tensor.ndim == 2:
      return tensor[:, :, None]
    if tensor.ndim > 3:
      return tensor.reshape(batch, list_size, -1)
    return tensor

  parts = []
  for name in sorted(context_features):
    t = context_features[name].reshape(batch, -1).to(torch.float32)
    parts.append(t[:, None, :].expand(batch, list_size, t.shape[-1]))
  example_parts = {name: _as_3d(example_features[name]).to(torch.float32)
                   for name in sorted(example_features)}
  if circular_padding and example_parts:
    indices, _ = list_ops.padded_gather_indices(mask)
    example_parts = {name: list_ops.gather_per_row(t, indices)
                     for name, t in example_parts.items()}
  parts.extend(example_parts[name] for name in sorted(example_parts))
  if not parts:
    raise ValueError('No features to concatenate.')
  if len(parts) == 1:
    return parts[0]  # a one-part concatenation would only copy it
  return torch.cat(parts, dim=-1)


_ACTIVATIONS: Dict[str, Callable[[Tensor], Tensor]] = {
    'relu': F.relu,
    'tanh': torch.tanh,
    'gelu': lambda x: F.gelu(x, approximate='tanh'),  # jax.nn.gelu default
    'elu': F.elu,
    'sigmoid': torch.sigmoid,
    'swish': F.silu,
    'linear': lambda x: x,
}

# Kernel initializers by name, as jax.nn.initializers defines them:
# (scale, fan mode, distribution) of variance scaling. 'glorot_uniform'
# is the reference create_tower's init (keras Dense default);
# 'lecun_normal' is flax's.
_INITIALIZERS = {
    'lecun_normal': (1.0, 'fan_in', 'truncated_normal'),
    'lecun_uniform': (1.0, 'fan_in', 'uniform'),
    'glorot_uniform': (1.0, 'fan_avg', 'uniform'),
    'glorot_normal': (1.0, 'fan_avg', 'truncated_normal'),
    'he_normal': (2.0, 'fan_in', 'truncated_normal'),
    'he_uniform': (2.0, 'fan_in', 'uniform'),
}

# jax.nn.initializers.variance_scaling: the std of a standard normal
# truncated to [-2, 2].
_TRUNCATED_NORMAL_STD = .87962566103423978


def kernel_initializer(name: str) -> Callable[[Tensor, torch.Generator], None]:
  """In-place initializer of a ``[out, in]`` Linear weight, by name."""
  if name not in _INITIALIZERS:
    raise ValueError(
        f'Unknown kernel_init {name!r}; one of {sorted(_INITIALIZERS)}')
  scale, mode, distribution = _INITIALIZERS[name]

  def init(weight: Tensor, generator: torch.Generator) -> None:
    fan_out, fan_in = weight.shape
    fan = fan_in if mode == 'fan_in' else (fan_in + fan_out) / 2
    variance = scale / fan
    with torch.no_grad():
      if distribution == 'uniform':
        limit = math.sqrt(3.0 * variance)
        nn.init.uniform_(weight, -limit, limit, generator=generator)
      else:
        std = math.sqrt(variance) / _TRUNCATED_NORMAL_STD
        nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)

  return init


def _batch_norm(dim: int, momentum: float) -> nn.BatchNorm1d:
  # flax's BatchNorm keeps ra = momentum * ra + (1 - momentum) * batch;
  # torch's keeps ra = (1 - momentum) * ra + momentum * batch. So flax
  # momentum 0.999 is torch momentum 0.001. eps 1e-5 is flax's default.
  return nn.BatchNorm1d(dim, eps=1e-5, momentum=1.0 - momentum)


class Tower(nn.Module):
  """Feed-forward scoring tower: [BN] -> (Linear -> BN -> act -> dropout)*
  -> Linear (create_tower, keras/layers.py:26-77).

  Inference only: batch norm uses its running statistics and dropout is a
  no-op. Parameters are float32.
  """

  def __init__(
      self,
      in_features: int,
      hidden_layer_dims: Sequence[int],
      output_units: int = 1,
      activation: str = 'relu',
      input_batch_norm: bool = False,
      use_batch_norm: bool = True,
      batch_norm_momentum: float = 0.999,
      dropout: float = 0.5,
      kernel_init: str = 'lecun_normal',
      generator: Optional[torch.Generator] = None,
  ):
    super().__init__()
    if activation not in _ACTIVATIONS:
      raise ValueError(f'Unknown activation {activation!r}; one of '
                       f'{sorted(_ACTIVATIONS)}')
    self.activation = activation
    self.dropout = dropout
    self.kernel_init = kernel_init
    dims = [in_features, *hidden_layer_dims]
    self.input_bn = (_batch_norm(in_features, batch_norm_momentum)
                     if input_batch_norm else None)
    self.dense = nn.ModuleList(
        [nn.Linear(d_in, d_out) for d_in, d_out in zip(dims[:-1], dims[1:])]
        + [nn.Linear(dims[-1], output_units)])
    self.bn = nn.ModuleList(
        [_batch_norm(d, batch_norm_momentum) for d in hidden_layer_dims]
        if use_batch_norm else [])
    self.reset_parameters(generator)

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    """Named-initializer kernels, zero biases, identity batch norms."""
    generator = torch.Generator() if generator is None else generator
    init = kernel_initializer(self.kernel_init)
    for layer in self.dense:
      init(layer.weight, generator)
      nn.init.zeros_(layer.bias)
    for bn in self.bn:
      bn.reset_parameters()
    if self.input_bn is not None:
      self.input_bn.reset_parameters()

  @staticmethod
  def _apply_bn(bn: nn.BatchNorm1d, x: Tensor) -> Tensor:
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, training=False, eps=bn.eps)

  def forward(self, x: Tensor, training: bool = False) -> Tensor:
    if training:
      raise NotImplementedError(TRAINING_NOT_PORTED)
    act = _ACTIVATIONS[self.activation]
    x = x.to(torch.float32)
    if self.input_bn is not None:
      x = self._apply_bn(self.input_bn, x)
    for i, layer in enumerate(self.dense[:-1]):
      x = layer(x)
      if self.bn:
        x = self._apply_bn(self.bn[i], x)
      x = act(x)
    return self.dense[-1](x)
