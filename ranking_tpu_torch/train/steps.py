"""The eval step.

The port's copy of the eval half of ``ranking_tpu/train/steps.py``:
``eval_step(model, batch, metric_states) -> (metric_states, logits)`` runs
the model in eval mode and streams every metric into a ``MeanState``, all
on the device with no host synchronization. The train step is the next
slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from ranking_tpu_torch.data.batch import RankingBatch
from ranking_tpu_torch.ops.metric_registry import MeanState
from ranking_tpu_torch.utils import list_ops
from ranking_tpu_torch.utils.device import DeviceLike, resolve_device

Tensor = torch.Tensor
MetricFn = Callable[..., Tuple[Tensor, Tensor]]


def restore_flat_examples(batch: RankingBatch) -> RankingBatch:
  """Restores ``[B*L, ...]`` example features to ``[B, L, ...]``.

  The host side of the pair is ``data.dataset.flatten_examples``. A leaf is
  restored iff its leading axis is ``B*L`` (mask gives B, L), exactly the
  JAX package's predicate; L == 1 batches are returned untouched.
  """
  b, l = batch.mask.shape
  if l <= 1:
    return batch
  examples = {
      k: (v.reshape((b, l) + tuple(v.shape[1:]))
          if v.ndim >= 1 and v.shape[0] == b * l else v)
      for k, v in batch.examples.items()}
  return batch.replace(examples=examples)


def make_eval_step(
    metric_fns: Mapping[str, MetricFn],
    loss_fn: Optional[Callable[..., Tensor]] = None,
    device: DeviceLike = 'cuda',
) -> Callable[..., Tuple[Dict[str, MeanState], Any]]:
  """Builds ``eval_step(model, batch, metric_states, num_valid_rows=None)
  -> (metric_states, logits)``.

  ``metric_fns`` maps display name -> fn from
  ``ops.metric_registry.make_ranking_metric_fn``. The batch moves to
  ``device``; the model must already be there.

  If ``loss_fn`` is given, ``loss_fn(labels, logits, features=...) ->
  scalar`` streams into a reserved ``'loss'`` state weighted by the
  batch's count of lists with a valid item (the reference's val_loss).
  """
  device = resolve_device(device)
  if loss_fn is not None and 'loss' in metric_fns:
    raise ValueError("'loss' is reserved for the validation loss state; "
                     'rename the metric.')

  @torch.no_grad()
  def eval_step(model, batch: RankingBatch,
                metric_states: Dict[str, MeanState],
                num_valid_rows: Optional[int] = None):
    """``num_valid_rows``: rows >= this index are padding
    (RankingBatch.pad_to) and get metric weight 0. An all-invalid list is
    not weightless in the reference's metric semantics (NDCG gives it
    value 0, weight 1), so padded rows would otherwise bias every
    unweighted metric down. None = every row is real data."""
    batch = restore_flat_examples(batch.to(device))
    logits = model(batch.context, batch.examples, batch.mask, training=False)
    # One shared sort per (scores, mask) across the metric suite, plus
    # NDCG's ideal sorts; results are identical to unshared sorts.
    with list_ops.shared_sort_scope():
      out = {}
      for name, fn in metric_fns.items():
        values, weights = fn(batch.labels, logits, features=batch.features)
        if num_valid_rows is not None:
          rows = torch.arange(weights.shape[0], device=device) < num_valid_rows
          weights = weights * rows.reshape(
              (-1,) + (1,) * (weights.ndim - 1)).to(weights.dtype)
        out[name] = metric_states[name].update(values, weights)
    if loss_fn is not None:
      loss = loss_fn(batch.labels, logits, features=batch.features)
      # Weight by the batch's valid-list count so a ragged final batch
      # contributes proportionally; an all-padding batch gets weight 0 and
      # a zeroed value (its loss over no list is typically NaN).
      n_lists = torch.sum(torch.any(batch.mask, dim=-1).to(torch.float32))
      loss = torch.where(n_lists > 0, loss, 0.0)
      out['loss'] = metric_states['loss'].update(loss[None], n_lists[None])
    return out, logits

  return eval_step


def init_metric_states(metric_fns: Mapping[str, MetricFn],
                       with_loss: bool = False,
                       device: DeviceLike = 'cuda') -> Dict[str, MeanState]:
  device = resolve_device(device)
  states = {name: MeanState.zero(device) for name in metric_fns}
  if with_loss:
    states['loss'] = MeanState.zero(device)
  return states


def metric_results(metric_states: Mapping[str, MeanState]) -> Dict[str, Tensor]:
  return {name: s.result() for name, s in metric_states.items()}
