"""Ranking model layers: feature concatenation, list restore, scoring tower.

The port's copy of the DNN parts of ``ranking_tpu/models/layers.py`` (the
reference's tensorflow_ranking/python/keras/layers.py). The data model is
the framework's: context features ``[B, ...]``, example features
``[B, L, ...]``, a boolean ``mask [B, L]``.

The tower runs in eval and in train mode. In train mode with batch norm,
relu and no dropout its hidden chain is the fused masked-BN kernels of
``ops/cuda/fused_bn.py``; every other configuration takes the unfused
chain with the port's own batch-norm arithmetic (flax's: fast variance
clipped at 0, biased variance in the running average).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ranking_tpu_torch.ops.cuda import fused_bn
from ranking_tpu_torch.utils import list_ops

Tensor = torch.Tensor

# Score of a padded slot; the JAX package's restore_list fill.
PADDING_LOGIT = math.log(1e-10)

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


def dropout_mask(shape, rate: float, generator: torch.Generator,
                 device) -> Tensor:
  """Inverted-dropout factors: 0 with probability ``rate``, else
  ``1 / (1 - rate)``. One generator state gives one mask."""
  keep = torch.rand(shape, generator=generator, device=device) >= rate
  return keep.to(torch.float32) / (1.0 - rate)


class Tower(nn.Module):
  """Feed-forward scoring tower: [BN] -> (Linear -> BN -> act -> dropout)*
  -> Linear (create_tower, keras/layers.py:26-77).

  ``dtype`` is the compute precision of the activations (float32 or
  bfloat16); parameters and batch statistics stay float32.
  ``input_grad=False`` declares the tower input's gradient unused (a
  ``detach()`` on every path; the fused backward then skips its largest
  write). Only set it when nothing trainable feeds the tower.

  In train mode the running statistics are updated in place, flax's way:
  ``ra = momentum * ra + (1 - momentum) * batch`` with the biased batch
  variance (torch's own BatchNorm would store the unbiased one).
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
      dtype: torch.dtype = torch.float32,
      input_grad: bool = True,
  ):
    super().__init__()
    if activation not in _ACTIVATIONS:
      raise ValueError(f'Unknown activation {activation!r}; one of '
                       f'{sorted(_ACTIVATIONS)}')
    self.activation = activation
    self.dropout = dropout
    self.kernel_init = kernel_init
    self.dtype = dtype
    self.input_grad = input_grad
    self.use_batch_norm = use_batch_norm
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

  def fused_ok(self, x: Tensor, training: bool) -> bool:
    """Whether this call takes the fused masked-BN path."""
    return (fused_bn.eligible(training, self.use_batch_norm,
                              self.input_bn is not None, self.dropout,
                              self.activation, self.dtype, x)
            and len(self.dense) > 1)

  @staticmethod
  def _update_running(bn: nn.BatchNorm1d, mean: Tensor, var: Tensor) -> None:
    with torch.no_grad():
      bn.running_mean.lerp_(mean.detach().to(torch.float32), bn.momentum)
      bn.running_var.lerp_(var.detach().to(torch.float32), bn.momentum)
      bn.num_batches_tracked += 1

  def _apply_bn(self, bn: nn.BatchNorm1d, x: Tensor,
                training: bool) -> Tensor:
    if not training:
      return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                          bn.bias, training=False, eps=bn.eps).to(x.dtype)
    # flax's BatchNorm: float32 statistics over all rows, fast variance.
    x32 = x.to(torch.float32)
    mean = x32.mean(0)
    var = torch.clamp((x32 * x32).mean(0) - mean * mean, min=0.0)
    self._update_running(bn, mean, var)
    y = (x32 - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias
    return y.to(x.dtype)

  def _fused_forward(self, x: Tensor, row_mask: Optional[Tensor]) -> Tensor:
    hidden = self.dense[:-1]
    if row_mask is None:
      row_mask = torch.ones((x.shape[0],), dtype=torch.float32,
                            device=x.device)
    out, means, vars_ = fused_bn.fused_bn_mlp(
        x, row_mask, [l.weight for l in hidden], [l.bias for l in hidden],
        [bn.weight for bn in self.bn], [bn.bias for bn in self.bn],
        self.bn[0].eps, act_dtype=self.dtype, input_grad=self.input_grad)
    for bn, mean, var in zip(self.bn, means, vars_):
      self._update_running(bn, mean, var)
    last = self.dense[-1]
    out = F.linear(out, last.weight.to(self.dtype), last.bias.to(self.dtype))
    return out.to(torch.float32)

  def forward(self, x: Tensor, training: bool = False,
              row_mask: Optional[Tensor] = None,
              generator: Optional[torch.Generator] = None) -> Tensor:
    """``row_mask`` (fused path only): ``[N]`` row validity; the batch
    statistics become the exact masked moments. The unfused chain ignores
    it (its caller pads circularly instead). ``generator`` draws the
    dropout masks in train mode and must live on ``x``'s device."""
    if not self.input_grad:
      x = x.detach()  # the same semantics on every path
    if self.fused_ok(x, training):
      return self._fused_forward(x, row_mask)
    act = _ACTIVATIONS[self.activation]
    x = x.to(self.dtype)
    if self.input_bn is not None:
      x = self._apply_bn(self.input_bn, x, training)
    for i, layer in enumerate(self.dense[:-1]):
      x = F.linear(x, layer.weight.to(self.dtype), layer.bias.to(self.dtype))
      if self.bn:
        x = self._apply_bn(self.bn[i], x, training)
      x = act(x)
      if self.dropout and training:
        if generator is None:
          raise ValueError('training with dropout needs a torch.Generator')
        x = x * dropout_mask(x.shape, self.dropout, generator,
                             x.device).to(x.dtype)
    last = self.dense[-1]
    x = F.linear(x, last.weight.to(self.dtype), last.bias.to(self.dtype))
    return x.to(torch.float32)
