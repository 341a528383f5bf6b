"""Metric key registry, factory, and streaming mean state.

The port's copy of ``ranking_tpu/ops/metric_registry.py`` (the
reference's tensorflow_ranking/python/metrics.py): every one of the 13
metric keys, the metric-fn factory (also over ragged host lists), the
one-shot ``compute_mean`` and ``eval_metric``. ``MeanState`` holds (sum of
value*weight, sum of weight) as device tensors: a batch adds to it without
a host synchronization.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, Optional, Tuple

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


def build_metric(
    metric_key: str,
    topn: Optional[int] = None,
    name: str = '',
    gain_fn: Callable[[Tensor], Tensor] = metrics_impl.DEFAULT_GAIN_FN,
    rank_discount_fn: Callable[[Tensor], Tensor] = (
        metrics_impl.DEFAULT_RANK_DISCOUNT_FN),
    **kwargs: Any,
) -> metrics_impl.RankingMetric:
  """Instantiates the metric object behind a key."""
  # Typos must not silently produce a different metric: only the keys
  # below consume extra kwargs.
  allowed = {RankingMetricKey.ALPHA_DCG: {'alpha'},
             RankingMetricKey.BPREF: {'use_trec_version'}}
  unknown = set(kwargs) - allowed.get(metric_key, set())
  if unknown:
    raise ValueError(
        f'{metric_key!r} does not accept options {sorted(unknown)}'
        + (f' (allowed: {sorted(allowed[metric_key])})'
           if metric_key in allowed else ''))
  name = name or (f'{metric_key}_{topn}' if topn else metric_key)
  builders: Dict[str, Callable[..., metrics_impl.RankingMetric]] = {
      RankingMetricKey.MRR: metrics_impl.MRRMetric,
      RankingMetricKey.ARP: metrics_impl.ARPMetric,
      RankingMetricKey.NDCG: lambda **kw: metrics_impl.NDCGMetric(
          gain_fn=gain_fn, rank_discount_fn=rank_discount_fn, **kw),
      RankingMetricKey.DCG: lambda **kw: metrics_impl.DCGMetric(
          gain_fn=gain_fn, rank_discount_fn=rank_discount_fn, **kw),
      RankingMetricKey.PRECISION: metrics_impl.PrecisionMetric,
      RankingMetricKey.RECALL: metrics_impl.RecallMetric,
      RankingMetricKey.MAP: metrics_impl.MeanAveragePrecisionMetric,
      RankingMetricKey.PRECISION_IA: metrics_impl.PrecisionIAMetric,
      RankingMetricKey.ORDERED_PAIR_ACCURACY: metrics_impl.OPAMetric,
      RankingMetricKey.ALPHA_DCG: lambda **kw: metrics_impl.AlphaDCGMetric(
          rank_discount_fn=rank_discount_fn, **kwargs, **kw),
      RankingMetricKey.BPREF: lambda **kw: metrics_impl.BPrefMetric(
          **kwargs, **kw),
      RankingMetricKey.HITS: metrics_impl.HitsMetric,
      RankingMetricKey.PWA: metrics_impl.PWAMetric,
  }
  if metric_key not in builders:
    raise ValueError(f'Invalid metric_key: {metric_key!r}. '
                     f'Valid keys: {RankingMetricKey.all_keys()}')
  if metric_key in (RankingMetricKey.ARP,
                    RankingMetricKey.ORDERED_PAIR_ACCURACY):
    # Full-list metrics: the reference factory accepts and ignores topn
    # for these keys (python/metrics.py); the metric classes themselves
    # raise if constructed with one directly.
    return builders[metric_key](name=name)
  return builders[metric_key](name=name, topn=topn)


def make_ranking_metric_fn(
    metric_key: str,
    weights_feature_name: Optional[str] = None,
    topn: Optional[int] = None,
    name: Optional[str] = None,
    gain_fn: Callable[[Tensor], Tensor] = metrics_impl.DEFAULT_GAIN_FN,
    rank_discount_fn: Callable[[Tensor], Tensor] = (
        metrics_impl.DEFAULT_RANK_DISCOUNT_FN),
    ragged: bool = False,
    **kwargs: Any,
) -> Callable[..., Tuple[Tensor, Tensor]]:
  """Factory: ``metric_fn(labels, predictions, features=None) ->
  (per_list_values, per_list_weights)`` (python/metrics.py:124-301).

  With ``ragged=True`` the metric fn takes host-side variable-length lists
  (lists of lists), densified on the CPU with the reference's padding
  (``list_ops.ragged_to_dense``). PWA's weights are passed as given: the
  metric checks that they are per-list ``[B, 1]``."""
  metric = build_metric(metric_key, topn=topn, name=name or '',
                        gain_fn=gain_fn, rank_discount_fn=rank_discount_fn,
                        **kwargs)

  def _metric_fn(labels, predictions, features=None):
    weights = None
    if weights_feature_name:
      if features is None or weights_feature_name not in features:
        raise ValueError(f'features must contain {weights_feature_name!r}')
      weights = features[weights_feature_name]
    if ragged:
      labels, predictions, weights, _ = list_ops.ragged_to_dense(
          labels, predictions, weights)
    if weights is not None:
      weights = torch.as_tensor(weights, dtype=torch.float32)
      if metric_key != RankingMetricKey.PWA:
        weights = list_ops.reshape_to_2d(weights)
    return metric(labels, predictions, weights=weights)

  return _metric_fn


def _weighted_mean(values: Tensor, weights: Tensor) -> Tensor:
  denom = torch.sum(weights)
  return torch.where(denom != 0, torch.sum(values * weights)
                     / torch.where(denom != 0, denom, 1.0), 0.0)


def compute_mean(
    metric_key: str,
    labels,
    predictions,
    weights=None,
    topn: Optional[int] = None,
    name: Optional[str] = None,
    **kwargs: Any,
) -> Tensor:
  """One-shot weighted-mean metric value (python/metrics.py:79-121)."""
  metric = build_metric(metric_key, topn=topn, name=name or '', **kwargs)
  values, wts = metric(labels, predictions, weights=weights)
  return _weighted_mean(values, wts)


def eval_metric(metric_fn, **kwargs) -> Tensor:
  """Stand-alone evaluation of a metric fn on ranked results.

  The analog of the reference's ``tfr.metrics.eval_metric``
  (python/metrics.py:650-705): arguments are passed by name and checked
  against the metric fn's signature, and the weighted mean is returned as
  a 0-d tensor.

  Example::

    value = eval_metric(
        metric_fn=make_ranking_metric_fn(RankingMetricKey.MRR),
        labels=torch.tensor([[0., 0., 1.]]),
        predictions=torch.tensor([[1., 3., 2.]]))
  """
  spec = inspect.getfullargspec(metric_fn)
  defaults = spec.defaults or ()
  fn_name = getattr(metric_fn, '__name__', repr(metric_fn))
  required = spec.args[: len(spec.args) - len(defaults)] + [
      n for n in spec.kwonlyargs if n not in (spec.kwonlydefaults or {})]
  for arg in required:
    if arg not in kwargs:
      raise ValueError(f'Metric {fn_name} requires argument {arg}.')
  accepted = set(spec.args) | set(spec.kwonlyargs)
  for arg in kwargs:
    if arg not in accepted:
      raise ValueError(f'Metric {fn_name} does not accept argument {arg}.')
  values, weights = metric_fn(**kwargs)
  return _weighted_mean(values, weights)


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
