"""Metric key registry, factory, and streaming mean state.

The port's copy of the NDCG and MRR parts of
``ranking_tpu/ops/metric_registry.py`` (the reference's
tensorflow_ranking/python/metrics.py). ``MeanState`` holds (sum of
value*weight, sum of weight) as device tensors: a batch adds to it without
a host synchronization.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from ranking_tpu_torch.ops import metrics as metrics_impl
from ranking_tpu_torch.utils import list_ops

Tensor = torch.Tensor


class RankingMetricKey:
  """Ranking metric key strings (parity with python/metrics.py:37-76)."""

  MRR = 'mrr'
  ARP = 'arp'
  NDCG = 'ndcg'
  DCG = 'dcg'
  PRECISION = 'precision'
  RECALL = 'recall'
  MAP = 'map'
  PRECISION_IA = 'precision_ia'
  ORDERED_PAIR_ACCURACY = 'ordered_pair_accuracy'
  ALPHA_DCG = 'alpha_dcg'
  BPREF = 'bpref'
  HITS = 'hits'
  PWA = 'pwa'

  @classmethod
  def all_keys(cls):
    return [v for k, v in vars(cls).items()
            if k.isupper() and isinstance(v, str)]


_PORTED = (RankingMetricKey.MRR, RankingMetricKey.NDCG)


def build_metric(
    metric_key: str,
    topn: Optional[int] = None,
    name: str = '',
    gain_fn: Callable[[Tensor], Tensor] = metrics_impl.DEFAULT_GAIN_FN,
    rank_discount_fn: Callable[[Tensor], Tensor] = (
        metrics_impl.DEFAULT_RANK_DISCOUNT_FN),
) -> metrics_impl.RankingMetric:
  """Instantiates the metric object behind a key (NDCG and MRR so far)."""
  if metric_key not in RankingMetricKey.all_keys():
    raise ValueError(f'Invalid metric_key: {metric_key!r}. '
                     f'Valid keys: {RankingMetricKey.all_keys()}')
  if metric_key not in _PORTED:
    raise NotImplementedError(
        f'metric {metric_key!r} is not ported yet; the PyTorch port has '
        f'{list(_PORTED)}')
  name = name or (f'{metric_key}_{topn}' if topn else metric_key)
  if metric_key == RankingMetricKey.NDCG:
    return metrics_impl.NDCGMetric(name=name, topn=topn, gain_fn=gain_fn,
                                   rank_discount_fn=rank_discount_fn)
  return metrics_impl.MRRMetric(name=name, topn=topn)


def make_ranking_metric_fn(
    metric_key: str,
    weights_feature_name: Optional[str] = None,
    topn: Optional[int] = None,
    name: Optional[str] = None,
    gain_fn: Callable[[Tensor], Tensor] = metrics_impl.DEFAULT_GAIN_FN,
    rank_discount_fn: Callable[[Tensor], Tensor] = (
        metrics_impl.DEFAULT_RANK_DISCOUNT_FN),
) -> Callable[..., Tuple[Tensor, Tensor]]:
  """Factory: ``metric_fn(labels, predictions, features=None) ->
  (per_list_values, per_list_weights)`` (python/metrics.py:124-301)."""
  metric = build_metric(metric_key, topn=topn, name=name or '',
                        gain_fn=gain_fn, rank_discount_fn=rank_discount_fn)

  def _metric_fn(labels, predictions, features=None):
    weights = None
    if weights_feature_name:
      if features is None or weights_feature_name not in features:
        raise ValueError(f'features must contain {weights_feature_name!r}')
      weights = list_ops.reshape_to_2d(torch.as_tensor(
          features[weights_feature_name], dtype=torch.float32))
    return metric(labels, predictions, weights=weights)

  return _metric_fn


@dataclasses.dataclass
class MeanState:
  """Streaming weighted mean: add per batch, merge across streams."""

  total: Tensor
  count: Tensor

  @classmethod
  def zero(cls, device='cpu') -> 'MeanState':
    return cls(total=torch.zeros((), dtype=torch.float32, device=device),
               count=torch.zeros((), dtype=torch.float32, device=device))

  def update(self, values: Tensor, weights) -> 'MeanState':
    # Flatten both sides before pairing: metric fns return [B, 1] values
    # while callers may hold [B] weights, and broadcasting would pair them
    # as [B, B], computing sum(v)*sum(w) instead of the weighted mean.
    values = torch.as_tensor(values, dtype=torch.float32).reshape(-1)
    weights = torch.as_tensor(weights, dtype=torch.float32,
                              device=values.device)
    if weights.ndim == 0:
      weights = weights.expand(values.shape)
    weights = weights.reshape(-1)
    if values.shape != weights.shape:
      raise ValueError(
          f'MeanState.update: {values.shape[0]} values vs '
          f'{weights.shape[0]} weights')
    return MeanState(total=self.total + torch.sum(values * weights),
                     count=self.count + torch.sum(weights))

  def merge(self, other: 'MeanState') -> 'MeanState':
    return MeanState(self.total + other.total, self.count + other.count)

  def result(self) -> Tensor:
    nonzero = self.count != 0
    return torch.where(nonzero,
                       self.total / torch.where(nonzero, self.count, 1.0),
                       0.0)


def default_metric_fns(
    topns=(1, 5, 10, None),
) -> Dict[str, Callable[..., Tuple[Tensor, Tensor]]]:
  """The default eval set: NDCG at several cutoffs (keras/metrics.py:131)."""
  out = {}
  for topn in topns:
    label = f'ndcg_{topn}' if topn else 'ndcg'
    out[f'metric/{label}'] = make_ranking_metric_fn(
        RankingMetricKey.NDCG, topn=topn)
  return out
