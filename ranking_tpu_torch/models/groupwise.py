"""Groupwise (multivariate) scoring: documents scored jointly in small groups.

The port's copy of ``ranking_tpu/models/groupwise.py`` (the reference's
legacy groupwise model, tensorflow_ranking/python/model.py:273-421). For
``group_size = g``, rolling windows of g documents are formed circularly
over the valid items of each list (model.py:164-244), every group is scored
jointly by one tower with g outputs, and each document's logit is the mean
of its scores over all groups that hold it (model.py:388-419). In training,
``num_shuffles`` shuffles of the valid items reduce window-composition
bias (model.py:313-339); eval and serving use the fixed windows, as in the
JAX package.

Every shape is static: windows are formed for all L positions, and the
invalid ones are masked out of the mean.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ranking_tpu_torch.models import layers as layers_lib
from ranking_tpu_torch.parallel import comm
from ranking_tpu_torch.utils import list_ops

Tensor = torch.Tensor
FeatureDict = Dict[str, Tensor]


def rolling_group_indices(
    mask: Tensor,
    group_size: int,
    draws: Optional[Tensor] = None,
):
  """Circular rolling-window group indices over the valid items.

  The valid items come first in list order, or shuffled by ``[B, L]``
  uniform ``draws`` (``list_ops.organize_valid_indices``).

  Returns:
    indices: ``[B, L, g]`` int64 positions into the original list,
    group_mask: ``[B, L]`` bool, window i is real iff i < num_valid.
  """
  batch, list_size = mask.shape
  valid_first = list_ops.organize_valid_indices(mask, draws=draws)
  num_valid = torch.sum(mask.to(torch.int64), dim=1, keepdim=True)
  safe_n = torch.clamp(num_valid, min=1)
  starts = torch.arange(list_size, device=mask.device)[:, None]     # [L, 1]
  offsets = torch.arange(group_size, device=mask.device)[None, :]   # [1, g]
  windows = torch.remainder(starts + offsets, safe_n[:, :, None])   # [B, L, g]
  indices = torch.gather(valid_first, 1,
                         windows.reshape(batch, -1)).reshape(windows.shape)
  group_mask = torch.arange(list_size, device=mask.device)[None, :] < num_valid
  return indices, group_mask


def scatter_group_scores(
    group_scores: Tensor,
    indices: Tensor,
    group_mask: Tensor,
    list_size: int,
) -> Tensor:
  """The mean of the group scores of each document.

  Args:
    group_scores: ``[B, G, g]`` scores of each group member.
    indices: ``[B, G, g]`` document positions of each group member.
    group_mask: ``[B, G]`` validity of each group.

  Returns:
    ``[B, list_size]`` mean score of each document (0 where never scored).

  The JAX package adds into the documents (``.at[idx].add``). On CUDA a
  float ``scatter_add_`` is atomic and adds in no fixed order, so two runs
  could differ in their last bits. Here each document's sum is a reduction
  over a one-hot ``[B, G*g, L]`` product instead, which adds in one fixed
  order on every run.
  """
  batch = group_scores.shape[0]
  weights = group_mask[:, :, None].to(group_scores.dtype).expand(
      group_scores.shape).reshape(batch, -1, 1)
  one_hot = (indices.reshape(batch, -1, 1)
             == torch.arange(list_size, device=indices.device)).to(
                 group_scores.dtype)                     # [B, G*g, L]
  sums = torch.sum(one_hot * (group_scores.reshape(batch, -1, 1) * weights),
                   dim=1)
  counts = torch.sum(one_hot * weights, dim=1)
  return torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), 0.0)


class GroupwiseDNNScorer(nn.Module):
  """Joint scorer over rolling document groups with one shared tower.

  Each group's example features (g * F, after the context features) are
  concatenated and scored by a ``Tower`` with g outputs, ``tower`` (flax
  ``Tower_0``), as the legacy ``EstimatorBuilder`` group scoring function
  (python/estimator.py:397-470). ``in_features`` is ``context_width + g *
  example_width``. ``group_size=1`` is plain univariate scoring. The tower
  sees every window, valid or not, as the JAX package's does: its batch
  statistics include the invalid windows.
  """

  def __init__(
      self,
      in_features: int,
      group_size: int = 2,
      hidden_layer_dims: Sequence[int] = (256, 128),
      activation: str = 'relu',
      use_batch_norm: bool = True,
      batch_norm_momentum: float = 0.999,
      dropout: float = 0.5,
      num_shuffles: int = 1,
      kernel_init: str = 'lecun_normal',
      generator: Optional[torch.Generator] = None,
      dtype: torch.dtype = torch.float32,
  ):
    super().__init__()
    if num_shuffles < 1:
      # The legacy reference asserts this at build time (model.py:326); no
      # shuffle at all would give 0/0 logits.
      raise ValueError(f'num_shuffles must be >= 1, got {num_shuffles}')
    self.group_size = group_size
    self.num_shuffles = num_shuffles
    self.tower = layers_lib.Tower(
        in_features, hidden_layer_dims, output_units=group_size,
        activation=activation, use_batch_norm=use_batch_norm,
        batch_norm_momentum=batch_norm_momentum, dropout=dropout,
        kernel_init=kernel_init, generator=generator, dtype=dtype)

  def forward(self, context: FeatureDict, examples: FeatureDict,
              mask: Tensor, training: bool = False,
              generator: Optional[torch.Generator] = None,
              shuffle_draws: Optional[Tensor] = None) -> Tensor:
    """In training with ``group_size > 1`` the valid items are shuffled
    ``num_shuffles`` times, each by ``[B, L]`` uniform draws of
    ``generator``, or by ``shuffle_draws[s]`` (``[num_shuffles, B, L]``)
    where given; the generator then feeds only the dropout masks."""
    batch, list_size = mask.shape
    g = self.group_size
    feats = layers_lib.concat_features({}, examples, mask,
                                       circular_padding=False)  # [B, L, F]
    context_parts = [context[k].reshape(batch, -1).to(torch.float32)
                     for k in sorted(context)]
    context_vec = torch.cat(context_parts, dim=-1) if context_parts else None

    def score_groups(indices: Tensor, group_mask: Tensor) -> Tensor:
      # Member features [B, L, g, F] as [B*L, g*F].
      group_feats = torch.gather(
          feats, 1, indices.reshape(batch, -1, 1).expand(
              batch, list_size * g, feats.shape[-1]))
      flat = group_feats.reshape(batch * list_size, -1)
      if context_vec is not None:
        tiled = torch.repeat_interleave(context_vec, list_size, dim=0)
        flat = torch.cat([tiled, flat], dim=-1)
      scores = self.tower(flat, training=training, generator=generator)
      return scatter_group_scores(scores.reshape(batch, list_size, g),
                                  indices, group_mask, list_size)

    shuffle = training and g > 1
    num_shuffles = self.num_shuffles if shuffle else 1
    total = torch.zeros((batch, list_size), dtype=torch.float32,
                        device=mask.device)
    for s in range(num_shuffles):
      draws = None
      if shuffle:
        if shuffle_draws is not None:
          draws = shuffle_draws[s]
        elif generator is None:
          raise ValueError('training with group_size > 1 shuffles the '
                           'valid items and needs a torch.Generator')
        else:
          draws = comm.draw_rows(lambda s: torch.rand(
              s, generator=generator, dtype=torch.float32,
              device=generator.device), (batch, list_size))
      indices, group_mask = rolling_group_indices(mask, g, draws=draws)
      total = total + score_groups(indices, group_mask)
    logits = total / float(num_shuffles)
    return torch.where(mask, logits, layers_lib.PADDING_LOGIT)
