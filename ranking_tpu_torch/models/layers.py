"""Ranking model layers: feature concatenation, list restore, the scoring
tower, DIN attention, GAM and Bilinear.

The port's copy of ``ranking_tpu/models/layers.py`` (the reference's
tensorflow_ranking/python/keras/layers.py). The data model is the
framework's: context features ``[B, ...]``, example features
``[B, L, ...]``, a boolean ``mask [B, L]``.

The tower runs in eval and in train mode, over inputs of any rank >= 2
(batch norm reduces over every axis but the last, as flax's). In train mode
with batch norm, relu and no dropout its hidden chain over a 2-D input is
the fused masked-BN kernels of ``ops/cuda/fused_bn.py``; every other
configuration takes the unfused chain with the port's own batch-norm
arithmetic (flax's: fast variance clipped at 0, biased variance in the
running average).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ranking_tpu_torch.ops.cuda import fused_bn
from ranking_tpu_torch.parallel import comm
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
                 device, row_dim: Optional[int] = 0) -> Tensor:
  """Inverted-dropout factors: 0 with probability ``rate``, else
  ``1 / (1 - rate)``. One generator state gives one mask. ``row_dim`` is
  the axis of the batch's rows (None for a mask shared by them): inside a
  data-parallel step the mask is this rank's rows of the global batch's
  (``parallel.comm.draw_rows``)."""
  def draw(s):
    keep = torch.rand(s, generator=generator, device=device) >= rate
    return keep.to(torch.float32) / (1.0 - rate)
  if row_dim is None:
    return draw(tuple(shape))
  return comm.draw_rows(draw, shape, row_dim)


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
    # flax's BatchNorm reduces over every axis but the last.
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    if not training:
      return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                          bn.bias, training=False, eps=bn.eps).to(
                              x.dtype).reshape(shape)
    # float32 statistics over all rows, fast variance; inside a
    # data-parallel step over the global batch's rows.
    x32 = x.to(torch.float32)
    mean, mean_sq = comm.row_means([x32, x32 * x32])
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    self._update_running(bn, mean, var)
    y = (x32 - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias
    return y.to(x.dtype).reshape(shape)

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
    """``x``: ``[..., in_features]``. ``row_mask`` (fused path only, where
    ``x`` is 2-D): ``[N]`` row validity; the batch
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


def _variance_scaling_(tensor: Tensor, fan_in: int,
                       generator: torch.Generator) -> None:
  """In place: jax's ``variance_scaling(1.0, 'fan_in', 'truncated_normal')``
  (lecun_normal) over a fan-in the caller counts."""
  std = math.sqrt(1.0 / fan_in) / _TRUNCATED_NORMAL_STD
  with torch.no_grad():
    nn.init.trunc_normal_(tensor, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class SelfAttentionMask:
  """Builds a ``[B, 1, L, L]`` attention mask from a ``[B, L]`` validity
  mask (keras/layers.py:380-416): query i may attend to key j iff both are
  valid."""

  def __call__(self, mask: Tensor) -> Tensor:
    return mask[:, None, None, :] & mask[:, None, :, None]


class DenseGeneral(nn.Module):
  """A ``kernel`` and a ``bias`` in flax's ``DenseGeneral`` layout: the
  kernel's leading ``len(in_shape)`` axes are contracted with the input's
  trailing ones, in the input's dtype. With one input and one output axis
  it is flax's ``Dense`` (``kernel [in, out]``, lecun normal, zero bias)."""

  def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int],
               generator: torch.Generator):
    super().__init__()
    self.kernel = nn.Parameter(torch.empty(tuple(in_shape) + tuple(out_shape)))
    self.bias = nn.Parameter(torch.zeros(tuple(out_shape)))
    _variance_scaling_(self.kernel, math.prod(in_shape), generator)
    self.n_in = len(in_shape)

  def forward(self, x: Tensor, copied: bool = False) -> Tensor:
    """Under tensor parallelism (``parallel.mesh.shard_module`` split the
    kernel over the model group) a kernel split along an output axis is
    column-parallel: ``x``, replicated over the group, enters through the
    *copy* role (unless the caller ``copied`` it already) and the output
    is this rank's slice. One split along a contracted axis is
    row-parallel: the partial products are summed by the *reduce* role and
    the bias, whole on every rank, is added once, after the sum."""
    dim = self.__dict__.get('model_shards', {}).get('kernel')
    group = None if dim is None else self.__dict__['mesh'].model_group
    if dim is not None and dim >= self.n_in and not copied:
      x = comm.copy(x, group)
    dims = list(range(x.ndim - self.n_in, x.ndim))
    y = torch.tensordot(x, self.kernel.to(x.dtype),
                        dims=(dims, list(range(self.n_in))))
    if dim is not None and dim < self.n_in:
      y = comm.reduce(y, group)
    return y + self.bias.to(x.dtype)

  def column_parallel(self) -> bool:
    dim = self.__dict__.get('model_shards', {}).get('kernel')
    return dim is not None and dim >= self.n_in


class MultiHeadAttention(nn.Module):
  """Self-attention as flax's ``MultiHeadDotProductAttention`` computes it,
  in plain tensor operations: ``query``, ``key`` and ``value`` kernels of
  ``[F, heads, head_dim]``, an ``out`` kernel of ``[heads, head_dim, F_out]``;
  logits over ``head_dim ** -0.5``-scaled queries; masked logits set to
  float32's most negative value (not -inf: a query row with no valid key
  attends uniformly, as under flax, where a boolean mask in
  ``scaled_dot_product_attention`` would give NaN); a softmax; in training,
  dropout of the attention weights with one ``[L, L]`` mask shared by the
  batch and the heads (flax's ``broadcast_dropout``)."""

  def __init__(self, in_features: int, num_heads: int, qkv_features: int,
               out_features: int, dropout: float,
               generator: torch.Generator):
    super().__init__()
    if qkv_features % num_heads:
      raise ValueError(f'qkv_features {qkv_features} is not a multiple of '
                       f'num_heads {num_heads}')
    head_dim = qkv_features // num_heads
    self.dropout = dropout
    self.query = DenseGeneral((in_features,), (num_heads, head_dim),
                              generator)
    self.key = DenseGeneral((in_features,), (num_heads, head_dim),
                            generator)
    self.value = DenseGeneral((in_features,), (num_heads, head_dim),
                              generator)
    self.out = DenseGeneral((num_heads, head_dim), (out_features,),
                            generator)

  def forward(self, x: Tensor, mask: Tensor, training: bool = False,
              generator: Optional[torch.Generator] = None,
              weights_dropout: Optional[Tensor] = None) -> Tensor:
    """``x`` ``[B, L, F]``, ``mask`` ``[B, 1, L, L]`` (or any shape that
    broadcasts to ``[B, 1, L, L]``) -> ``[B, L, F_out]``. In training the
    dropout factors of the weights are ``weights_dropout`` (``[1, 1, L,
    L]``, drawn by the caller) where given, else drawn from
    ``generator``."""
    # Column-parallel projections (heads split over the model group)
    # share one copy of their input: one all-reduce of its gradient.
    copied = self.query.column_parallel()
    if copied:
      x = comm.copy(x, self.query.__dict__['mesh'].model_group)
    q, k, v = (self.query(x, copied), self.key(x, copied),
               self.value(x, copied))                     # [B, L, H, D]
    q = q / math.sqrt(q.shape[-1])
    logits = torch.einsum('bqhd,bkhd->bhqk', q, k)
    logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    weights = torch.softmax(logits, dim=-1)
    if training and self.dropout > 0.0:
      if weights_dropout is None:
        if generator is None:
          raise ValueError('training with dropout needs a torch.Generator')
        weights_dropout = dropout_mask(
            (1, 1) + tuple(weights.shape[-2:]), self.dropout, generator,
            x.device, row_dim=None)
      weights = weights * weights_dropout.to(weights.dtype)
    return self.out(torch.einsum('bhqk,bkhd->bqhd', weights, v))


def layer_norm(x: Tensor, weight: Tensor, bias: Tensor,
               eps: float) -> Tensor:
  """flax's ``LayerNorm`` over the last axis: statistics in float32 (or in
  ``x``'s wider type), the fast variance ``mean(x^2) - mean(x)^2`` clipped
  at 0, and ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""
  x32 = x.to(torch.promote_types(x.dtype, torch.float32))
  mean = x32.mean(-1, keepdim=True)
  var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mean * mean,
                    min=0.0)
  return ((x32 - mean) * (torch.rsqrt(var + eps) * weight) + bias).to(x.dtype)


class DocumentInteractionAttention(nn.Module):
  """Cross-document attention over the list axis (DIN; keras/layers.py:420).

  A bias-free projection of ``[B, L, in_features]`` to ``head_size``, then
  ``num_layers`` blocks of LayerNorm (eps 1e-6) -> self-attention masked to
  the valid documents -> dropout -> residual. Output ``[B, L, head_size]``
  float32. The flax submodules ``Dense_0``, ``LayerNorm_i`` and
  ``MultiHeadDotProductAttention_i`` are ``dense``, ``norms.i`` and
  ``attentions.i`` here.
  """

  def __init__(self, in_features: int, num_heads: int = 2,
               head_size: int = 100, num_layers: int = 1,
               dropout: float = 0.5,
               generator: Optional[torch.Generator] = None,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    generator = torch.Generator() if generator is None else generator
    self.dropout = dropout
    self.dtype = dtype
    self.dense = nn.Linear(in_features, head_size, bias=False)
    _variance_scaling_(self.dense.weight, in_features, generator)
    self.norms = nn.ModuleList(
        [nn.LayerNorm(head_size, eps=1e-6) for _ in range(num_layers)])
    self.attentions = nn.ModuleList(
        [MultiHeadAttention(head_size, num_heads, head_size, head_size,
                            dropout, generator) for _ in range(num_layers)])

  def forward(self, x: Tensor, mask: Tensor, training: bool = False,
              generator: Optional[torch.Generator] = None) -> Tensor:
    x = F.linear(x.to(self.dtype), self.dense.weight.to(self.dtype))
    attention_mask = SelfAttentionMask()(mask)
    for norm, attention in zip(self.norms, self.attentions):
      y = layer_norm(x, norm.weight, norm.bias, norm.eps)
      y = attention(y, attention_mask, training=training, generator=generator)
      if training and self.dropout:
        if generator is None:
          raise ValueError('training with dropout needs a torch.Generator')
        y = y * dropout_mask(y.shape, self.dropout, generator,
                             y.device).to(y.dtype)
      x = x + y
    return x.to(torch.float32)


class GAMLayer(nn.Module):
  """Generalized Additive Model over per-feature towers
  (keras/layers.py:591-803, "Interpretable Ranking with GAMs").

  Example feature i (``[..., example_widths[i]]``) goes through its own
  tower ``example_tower_i`` to one sub-score; with context features, each
  (``[..., context_widths[j]]``) goes through ``context_tower_j`` to
  ``len(example_widths)`` logits whose softmax weighs the sub-scores, the
  weights of all context towers summed. The forward returns ``(scores
  [..., 1], sub-scores [..., F_e])``. Context inputs that lack the example
  inputs' list axis broadcast over it.

  The example towers keep their parameters one tower a module (flax's
  names), but run as one stack: each layer is one batched product over
  ``[F_e, N, d]`` of the towers' stacked weights (inputs narrower than the
  widest zero-padded, with their kernels), one batch norm over the rows of
  every tower and one dropout mask, so that a forward costs a few
  launches a layer whatever F_e is. Each tower computes what ``Tower``
  computes on its own input.
  """

  def __init__(
      self,
      example_widths: Sequence[int],
      example_hidden_layer_dims: Sequence[int],
      context_widths: Sequence[int] = (),
      context_hidden_layer_dims: Sequence[int] = (),
      activation: str = 'relu',
      use_batch_norm: bool = True,
      batch_norm_momentum: float = 0.999,
      dropout: float = 0.0,
      kernel_init: str = 'lecun_normal',
      generator: Optional[torch.Generator] = None,
      dtype: torch.dtype = torch.float32,
  ):
    super().__init__()
    generator = torch.Generator() if generator is None else generator
    self.example_feature_num = len(example_widths)
    self.context_feature_num = len(context_widths)
    tower = dict(activation=activation, use_batch_norm=use_batch_norm,
                 batch_norm_momentum=batch_norm_momentum, dropout=dropout,
                 kernel_init=kernel_init, generator=generator, dtype=dtype)
    for i, width in enumerate(example_widths):
      self.add_module(f'example_tower_{i}', Tower(
          width, example_hidden_layer_dims, output_units=1, **tower))
    for i, width in enumerate(context_widths):
      self.add_module(f'context_tower_{i}', Tower(
          width, context_hidden_layer_dims,
          output_units=self.example_feature_num, **tower))

  def forward(self, example_inputs: Sequence[Tensor],
              context_inputs: Sequence[Tensor] = (), training: bool = False,
              generator: Optional[torch.Generator] = None):
    if len(example_inputs) != self.example_feature_num:
      raise ValueError(
          f'Expected {self.example_feature_num} example features, got '
          f'{len(example_inputs)}.')
    if len(context_inputs) != self.context_feature_num:
      raise ValueError(
          f'Expected {self.context_feature_num} context features, got '
          f'{len(context_inputs)} (0 means the context weighting towers '
          'are disabled).')
    sub_scores = self._stacked_towers(example_inputs, training, generator)
    if not context_inputs:
      return torch.sum(sub_scores, dim=-1, keepdim=True), sub_scores
    feature_weights = sum(
        torch.softmax(self.get_submodule(f'context_tower_{i}')(
            x, training=training, generator=generator), dim=-1)
        for i, x in enumerate(context_inputs))
    # Per-query weights [B, F_e] broadcast over a list axis of the
    # sub-scores [B, L, F_e].
    while feature_weights.ndim < sub_scores.ndim:
      feature_weights = feature_weights[..., None, :]
    return (torch.sum(sub_scores * feature_weights, dim=-1, keepdim=True),
            sub_scores)


  def _stacked_towers(self, inputs: Sequence[Tensor], training: bool,
                      generator: Optional[torch.Generator]) -> Tensor:
    """The example towers' sub-scores ``[..., F_e]``, all towers at once."""
    towers = [self.get_submodule(f'example_tower_{i}')
              for i in range(self.example_feature_num)]
    first = towers[0]
    act = _ACTIVATIONS[first.activation]
    width = max(x.shape[-1] for x in inputs)
    lead = inputs[0].shape[:-1]
    h = torch.stack([F.pad(x, (0, width - x.shape[-1])) for x in inputs])
    h = h.reshape(len(towers), -1, width).to(first.dtype)     # [T, N, w]
    last = len(first.dense) - 1
    for i in range(last + 1):
      kernels = [t.dense[i].weight for t in towers]
      if i == 0:
        kernels = [F.pad(k, (0, width - k.shape[1])) for k in kernels]
      w = torch.stack(kernels).to(first.dtype)                  # [T, out, in]
      b = torch.stack([t.dense[i].bias for t in towers]).to(first.dtype)
      h = torch.baddbmm(b[:, None, :], h, w.transpose(1, 2))
      if i == last:
        break
      if first.bn:
        h = _stacked_batch_norm([t.bn[i] for t in towers], h, training)
      h = act(h)
      if first.dropout and training:
        if generator is None:
          raise ValueError('training with dropout needs a torch.Generator')
        h = h * dropout_mask(h.shape, first.dropout, generator,
                             h.device, row_dim=1).to(h.dtype)
    return h[..., 0].to(torch.float32).transpose(0, 1).reshape(
        lead + (len(towers),))


def _stacked_batch_norm(bns: Sequence[nn.BatchNorm1d], h: Tensor,
                        training: bool) -> Tensor:
  """``Tower``'s batch norm of each of T towers at once: ``h`` is
  ``[T, N, d]``, tower t normalised by its own statistics (over its N rows
  in training, updating its running ones flax's way; its running ones in
  eval) and its own scale and offset."""
  scale = torch.stack([bn.weight for bn in bns])[:, None, :]
  offset = torch.stack([bn.bias for bn in bns])[:, None, :]
  eps = bns[0].eps
  h32 = h.to(torch.float32)
  if not training:
    mean = torch.stack([bn.running_mean for bn in bns])[:, None, :]
    var = torch.stack([bn.running_var for bn in bns])[:, None, :]
    return ((h32 - mean) * (torch.rsqrt(var + eps) * scale)
            + offset).to(h.dtype)
  mean, mean_sq = comm.row_means([h32, h32 * h32], dim=1)
  var = torch.clamp(mean_sq - mean * mean, min=0.0)
  with torch.no_grad():
    torch._foreach_lerp_([bn.running_mean for bn in bns],
                         list(mean.detach().unbind(0)), bns[0].momentum)
    torch._foreach_lerp_([bn.running_var for bn in bns],
                         list(var.detach().unbind(0)), bns[0].momentum)
    torch._foreach_add_([bn.num_batches_tracked for bn in bns], 1)
  y = (h32 - mean[:, None, :]) * (torch.rsqrt(var + eps)[:, None, :] * scale)
  return (y + offset).to(h.dtype)


class Bilinear(nn.Module):
  """Bilinear interaction x^T A y plus a bias, for two-tower unbiased LTR
  (keras/layers.py:807-891): ``x [..., Dx]``, ``y [..., Dy]`` ->
  ``[..., output_units]`` through the einsum ``'...i,ioj,...j->...o'``
  against a ``[Dx, output_units, Dy]`` kernel, ``bilinear_kernel``. The
  kernel's initial fan-in counts both contracted axes (Dx * Dy), as the
  JAX package's initializer does."""

  def __init__(self, x_features: int, y_features: int,
               output_units: int = 1,
               generator: Optional[torch.Generator] = None,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    generator = torch.Generator() if generator is None else generator
    self.dtype = dtype
    self.bilinear_kernel = nn.Parameter(
        torch.empty(x_features, output_units, y_features))
    self.bias = nn.Parameter(torch.zeros(output_units))
    _variance_scaling_(self.bilinear_kernel, x_features * y_features,
                       generator)

  def forward(self, x: Tensor, y: Tensor) -> Tensor:
    out = torch.einsum('...i,ioj,...j->...o', x.to(self.dtype),
                       self.bilinear_kernel.to(self.dtype),
                       y.to(self.dtype))
    return out.to(torch.float32) + self.bias
