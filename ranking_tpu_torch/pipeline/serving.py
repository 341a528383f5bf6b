"""Serving and standalone evaluation.

The port's copy of the inference half of ``ranking_tpu/pipeline/serving.py``:
``Predictor.score_batch`` scores a pre-assembled ``RankingBatch`` and
``evaluate_dataset`` streams metrics over a batch stream. Parsing
serialized requests (``predict``/``regress``), loading exports
(``from_export``) and query-id aggregated metrics are later slices.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ranking_tpu_torch.data.batch import RankingBatch
from ranking_tpu_torch.ops import metric_registry
from ranking_tpu_torch.train import steps
from ranking_tpu_torch.utils.device import DeviceLike, resolve_device


def _place(model: nn.Module, state_dict: Optional[Mapping[str, Any]],
           device: torch.device) -> nn.Module:
  if state_dict is not None:
    model.load_state_dict(state_dict)
  return model.to(device)


class Predictor:
  """Inference wrapper: a model with its parameters on the device.

  ``state_dict`` (e.g. from ``convert.from_flax``) is loaded into
  ``model``, which then moves to ``device``; None keeps the model's own
  parameters.
  """

  def __init__(self, model: nn.Module,
               state_dict: Optional[Mapping[str, Any]] = None,
               device: DeviceLike = 'cuda'):
    self.device = resolve_device(device)
    self.model = _place(model, state_dict, self.device)

  def score_batch(self, batch: RankingBatch) -> np.ndarray:
    """``[B, L]`` scores of a pre-assembled batch; padded slots score
    ``log(1e-10)``."""
    batch = batch.to(self.device)
    with torch.no_grad():
      scores = self.model(batch.context, batch.examples, batch.mask,
                          training=False)
    return scores.cpu().numpy()


def evaluate_dataset(
    model: nn.Module,
    state_dict: Optional[Mapping[str, Any]],
    batches: Iterable[RankingBatch],
    metric_fns: Optional[Mapping[str, Any]] = None,
    device: DeviceLike = 'cuda',
):
  """Streaming weighted-mean metrics over a ``RankingBatch`` stream.

  The default suite is NDCG@5 and MRR. Returns ``{name: float}``.
  """
  device = resolve_device(device)
  model = _place(model, state_dict, device)
  if metric_fns is None:
    metric_fns = {
        'ndcg@5': metric_registry.make_ranking_metric_fn(
            metric_registry.RankingMetricKey.NDCG, topn=5),
        'mrr': metric_registry.make_ranking_metric_fn(
            metric_registry.RankingMetricKey.MRR),
    }
  eval_step = steps.make_eval_step(metric_fns, device=device)
  states = steps.init_metric_states(metric_fns, device=device)
  for batch in batches:
    states, _ = eval_step(model, batch, states)
  return {k: float(v) for k, v in steps.metric_results(states).items()}
