"""String-keyed loss registry and weighted multi-loss factory.

The port's copy of ``ranking_tpu/ops/loss_registry.py`` (the reference's
tensorflow_ranking/python/losses.py): the same 25 ``RankingLossKey``
strings, ``build_loss`` for each of them, ``make_loss_fn`` building
``(labels, logits, features=None, generator=None) -> scalar`` from weighted
losses, with one shared Gumbel sample feeding every ``gumbel_*`` and
``yeti_*`` key of a call, and ``make_loss_metric_fn`` turning a loss into a
per-list eval stream. The JAX package's defaults hold: ``approx_ndcg_loss``,
``approx_mrr_loss`` and ``gumbel_approx_ndcg_loss`` build the
scale-invariant recipe (``scale_invariant=False`` restores the reference's),
and ``yeti_logistic_loss`` takes the Yeti DCG lambda weight unless given
``NO_LAMBDA``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from ranking_tpu_torch.ops import lambda_weights as lw
from ranking_tpu_torch.ops import losses as losses_lib
from ranking_tpu_torch.ops import sorting
from ranking_tpu_torch.ops.reductions import Reduction
from ranking_tpu_torch.utils import list_ops

Tensor = torch.Tensor
LossFn = Callable[..., Tensor]


class RankingLossKey:
  """Ranking loss key strings (parity with python/losses.py:29-54)."""

  PAIRWISE_HINGE_LOSS = 'pairwise_hinge_loss'
  PAIRWISE_LOGISTIC_LOSS = 'pairwise_logistic_loss'
  PAIRWISE_SOFT_ZERO_ONE_LOSS = 'pairwise_soft_zero_one_loss'
  PAIRWISE_MSE_LOSS = 'pairwise_mse_loss'
  YETI_LOGISTIC_LOSS = 'yeti_logistic_loss'
  CIRCLE_LOSS = 'circle_loss'
  SOFTMAX_LOSS = 'softmax_loss'
  CALIBRATED_SOFTMAX_LOSS = 'calibrated_softmax_loss'
  POLY_ONE_SOFTMAX_LOSS = 'poly_one_softmax_loss'
  UNIQUE_SOFTMAX_LOSS = 'unique_softmax_loss'
  SIGMOID_CROSS_ENTROPY_LOSS = 'sigmoid_cross_entropy_loss'
  MEAN_SQUARED_LOSS = 'mean_squared_loss'
  LIST_MLE_LOSS = 'list_mle_loss'
  APPROX_NDCG_LOSS = 'approx_ndcg_loss'
  APPROX_MRR_LOSS = 'approx_mrr_loss'
  GUMBEL_APPROX_NDCG_LOSS = 'gumbel_approx_ndcg_loss'
  NEURAL_SORT_CROSS_ENTROPY_LOSS = 'neural_sort_cross_entropy_loss'
  GUMBEL_NEURAL_SORT_CROSS_ENTROPY_LOSS = (
      'gumbel_neural_sort_cross_entropy_loss')
  NEURAL_SORT_NDCG_LOSS = 'neural_sort_ndcg_loss'
  GUMBEL_NEURAL_SORT_NDCG_LOSS = 'gumbel_neural_sort_ndcg_loss'
  ORDINAL_LOSS = 'ordinal_loss'
  MULTI_CLASS_LOSS = 'multi_class_loss'
  CLICK_EM_LOSS = 'click_em_loss'
  MIXTURE_EM_LOSS = 'mixture_em_loss'
  COUPLED_RANK_DISTIL_LOSS = 'coupled_rankdistil_loss'

  @classmethod
  def all_keys(cls):
    return [v for k, v in vars(cls).items()
            if k.isupper() and isinstance(v, str)]


# Keys whose inputs go through the shared Gumbel sampler first.
_GUMBEL_KEYS = frozenset({
    RankingLossKey.YETI_LOGISTIC_LOSS,
    RankingLossKey.GUMBEL_APPROX_NDCG_LOSS,
    RankingLossKey.GUMBEL_NEURAL_SORT_CROSS_ENTROPY_LOSS,
    RankingLossKey.GUMBEL_NEURAL_SORT_NDCG_LOSS,
})

# Keys that accept a lambda weight.
_LAMBDA_KEYS = frozenset({
    RankingLossKey.PAIRWISE_HINGE_LOSS,
    RankingLossKey.PAIRWISE_LOGISTIC_LOSS,
    RankingLossKey.PAIRWISE_SOFT_ZERO_ONE_LOSS,
    RankingLossKey.PAIRWISE_MSE_LOSS,
    RankingLossKey.YETI_LOGISTIC_LOSS,
    RankingLossKey.CIRCLE_LOSS,
    RankingLossKey.SOFTMAX_LOSS,
    RankingLossKey.CALIBRATED_SOFTMAX_LOSS,
    RankingLossKey.POLY_ONE_SOFTMAX_LOSS,
    RankingLossKey.UNIQUE_SOFTMAX_LOSS,
    RankingLossKey.LIST_MLE_LOSS,
})

# Explicit no-lambda override: suppresses a key-specific default lambda
# weight. The keras YetiLogisticLoss defaults to the neighbor-pair DCG
# weight (keras/losses.py:672), which build_loss mirrors on
# lambda_weight=None; the python-generation factory applies no lambda
# weight to the yeti key (python/losses.py:133), which NO_LAMBDA gives.
NO_LAMBDA = 'no_lambda'

# The keys built as the scale-invariant Approx* recipe by default (per-list
# logit standardization, sharpness 0.25: losses._standardize_logits). The
# JAX package measured the reference's fixed /0.1 recipe saturating the rank
# sigmoid at realistic list sizes, and the standardized form ahead at every
# list size from 10 to 200 (SI_SWEEP.json, APPROX_NDCG_DIAG.json).
# scale_invariant=False (temperature then 0.1) builds the reference's.
_SCALE_INVARIANT_DEFAULT_KEYS = frozenset({
    RankingLossKey.APPROX_NDCG_LOSS,
    RankingLossKey.APPROX_MRR_LOSS,
    RankingLossKey.GUMBEL_APPROX_NDCG_LOSS,
})
SCALE_INVARIANT_TEMPERATURE = 0.25

_LOSS_CLASSES: Dict[str, Callable[..., losses_lib.RankingLoss]] = {
    RankingLossKey.PAIRWISE_HINGE_LOSS: losses_lib.PairwiseHingeLoss,
    RankingLossKey.PAIRWISE_LOGISTIC_LOSS: losses_lib.PairwiseLogisticLoss,
    RankingLossKey.PAIRWISE_SOFT_ZERO_ONE_LOSS:
        losses_lib.PairwiseSoftZeroOneLoss,
    RankingLossKey.PAIRWISE_MSE_LOSS: losses_lib.PairwiseMSELoss,
    RankingLossKey.YETI_LOGISTIC_LOSS: losses_lib.PairwiseLogisticLoss,
    RankingLossKey.CIRCLE_LOSS: losses_lib.CircleLoss,
    RankingLossKey.SOFTMAX_LOSS: losses_lib.SoftmaxLoss,
    RankingLossKey.CALIBRATED_SOFTMAX_LOSS: losses_lib.CalibratedSoftmaxLoss,
    RankingLossKey.POLY_ONE_SOFTMAX_LOSS: losses_lib.PolyOneSoftmaxLoss,
    RankingLossKey.UNIQUE_SOFTMAX_LOSS: losses_lib.UniqueSoftmaxLoss,
    RankingLossKey.SIGMOID_CROSS_ENTROPY_LOSS:
        losses_lib.SigmoidCrossEntropyLoss,
    RankingLossKey.MEAN_SQUARED_LOSS: losses_lib.MeanSquaredLoss,
    RankingLossKey.LIST_MLE_LOSS: losses_lib.ListMLELoss,
    RankingLossKey.APPROX_NDCG_LOSS: losses_lib.ApproxNDCGLoss,
    RankingLossKey.APPROX_MRR_LOSS: losses_lib.ApproxMRRLoss,
    RankingLossKey.GUMBEL_APPROX_NDCG_LOSS: losses_lib.ApproxNDCGLoss,
    RankingLossKey.NEURAL_SORT_CROSS_ENTROPY_LOSS:
        losses_lib.NeuralSortCrossEntropyLoss,
    RankingLossKey.GUMBEL_NEURAL_SORT_CROSS_ENTROPY_LOSS:
        losses_lib.NeuralSortCrossEntropyLoss,
    RankingLossKey.NEURAL_SORT_NDCG_LOSS: losses_lib.NeuralSortNDCGLoss,
    RankingLossKey.GUMBEL_NEURAL_SORT_NDCG_LOSS:
        losses_lib.NeuralSortNDCGLoss,
    RankingLossKey.ORDINAL_LOSS: losses_lib.OrdinalLoss,
    RankingLossKey.MULTI_CLASS_LOSS: losses_lib.MultiClassLoss,
    RankingLossKey.CLICK_EM_LOSS: losses_lib.ClickEMLoss,
    RankingLossKey.MIXTURE_EM_LOSS: losses_lib.MixtureEMLoss,
    RankingLossKey.COUPLED_RANK_DISTIL_LOSS: losses_lib.CoupledRankDistilLoss,
}


def build_loss(
    loss_key: str,
    lambda_weight: Optional[Union[lw.LambdaWeight, str]] = None,
    name: str = '',
    **params: Any,
) -> losses_lib.RankingLoss:
  """Instantiates the loss object behind a key.

  ``params`` are loss-specific constructor arguments (temperature, gamma,
  margin, epsilon, ordinal_size, ...). Keys that take no lambda weight
  ignore it, as in the reference factory. ``lambda_weight=NO_LAMBDA``
  suppresses any key-specific default lambda weight (see NO_LAMBDA).
  """
  if loss_key not in _LOSS_CLASSES:
    raise ValueError(f'Invalid loss_key: {loss_key!r}. '
                     f'Valid keys: {RankingLossKey.all_keys()}')
  kw: Dict[str, Any] = dict(name=name or loss_key, **params)
  if loss_key in _SCALE_INVARIANT_DEFAULT_KEYS:
    kw.setdefault('scale_invariant', True)
    if kw['scale_invariant']:
      kw.setdefault('temperature', SCALE_INVARIANT_TEMPERATURE)
  if isinstance(lambda_weight, str) and lambda_weight == NO_LAMBDA:
    lambda_weight = None
  elif loss_key == RankingLossKey.YETI_LOGISTIC_LOSS and lambda_weight is None:
    lambda_weight = lw.create_yeti_dcg_lambda_weight()
  if loss_key in _LAMBDA_KEYS and lambda_weight is not None:
    kw['lambda_weight'] = lambda_weight
  return _LOSS_CLASSES[loss_key](**kw)


def _weights_from(features, weights_feature_name: Optional[str], like: Tensor):
  if not weights_feature_name:
    return None
  if features is None or weights_feature_name not in features:
    raise ValueError(f'features must contain {weights_feature_name!r}.')
  return list_ops.reshape_to_2d(
      torch.as_tensor(features[weights_feature_name],
                      device=like.device).to(torch.float32))


def make_loss_fn(
    loss_keys: Union[str, Sequence[str]],
    loss_weights: Optional[Sequence[float]] = None,
    weights_feature_name: Optional[str] = None,
    lambda_weight: Optional[Union[lw.LambdaWeight, str]] = None,
    reduction: Reduction = Reduction.SUM_BY_NONZERO_WEIGHTS,
    name: Optional[str] = None,
    params: Optional[Mapping[str, Any]] = None,
    gumbel_params: Optional[Mapping[str, Any]] = None,
) -> LossFn:
  """Builds ``loss_fn(labels, logits, features=None, generator=None) ->
  scalar``.

  Mirrors tensorflow_ranking/python/losses.py:265-311, including the
  ``'softmax_loss:0.9,sigmoid_cross_entropy_loss:0.1'`` encoded form and one
  Gumbel sample (``gumbel_params``: ``sample_size``, default 8, and
  ``temperature``, default 1) shared by every gumbel/yeti key of a call.
  ``generator`` draws that sample first, then each loss's tie shuffles in
  turn (a generator is a stream: there is no per-loss fold as with a JAX
  key). With None every call draws the same numbers: the kept draws of
  seed 17 for the sample, of seed 37 for the shuffles.
  """
  reduction = Reduction(reduction)
  if reduction == Reduction.NONE:
    raise ValueError('Reduction.NONE is not a valid training reduction.')

  if isinstance(loss_keys, str) and (':' in loss_keys or ',' in loss_keys):
    if loss_weights is not None:
      raise ValueError('loss_weights must be None when weights are encoded '
                       'in loss_keys.')
    keys_to_weights = list_ops.parse_keys_and_weights(loss_keys)
    loss_keys = list(keys_to_weights.keys())
    loss_weights = list(keys_to_weights.values())
  if isinstance(loss_keys, str):
    loss_keys = [loss_keys]
  if not loss_keys:
    raise ValueError('loss_keys cannot be None or empty.')
  if loss_weights and len(loss_keys) != len(loss_weights):
    raise ValueError('loss_keys and loss_weights must have the same size.')

  params = dict(params or {})
  gumbel_params = dict(gumbel_params or {})
  gumbel_sample_size = gumbel_params.pop('sample_size', 8)
  gumbel_temperature = gumbel_params.pop('temperature', 1.0)
  if gumbel_params:
    raise ValueError(f'Unknown gumbel_params: {sorted(gumbel_params)}')

  loss_objs = [build_loss(k, lambda_weight, name or k, **params)
               for k in loss_keys]
  needs_gumbel = any(k in _GUMBEL_KEYS for k in loss_keys)

  def _loss_fn(labels, logits, features=None, generator=None):
    logits = losses_lib._float(logits)
    labels = losses_lib._float(labels, logits)
    weights = _weights_from(features, weights_feature_name, logits)
    gbl = None
    if needs_gumbel:
      # Without a generator: the kept draws of seed 17, the JAX package's
      # fallback key (loss_registry.py:248-249).
      gbl = sorting.gumbel_sample_lists(
          labels, logits, generator, weights=weights,
          sample_size=gumbel_sample_size, temperature=gumbel_temperature)
    total = torch.zeros((), dtype=logits.dtype, device=logits.device)
    for i, (loss_key, loss_obj) in enumerate(zip(loss_keys, loss_objs)):
      l, s, w = gbl if loss_key in _GUMBEL_KEYS else (labels, logits, weights)
      value = loss_obj(l, s, weights=w, reduction=reduction,
                       generator=generator)
      if loss_weights:
        value = value * loss_weights[i]
      total = total + value
    return total

  return _loss_fn


def make_loss_metric_fn(
    loss_key: str,
    weights_feature_name: Optional[str] = None,
    lambda_weight: Optional[Union[lw.LambdaWeight, str]] = None,
    name: Optional[str] = None,
    **params: Any,
) -> Callable[..., Tuple[Tensor, Tensor]]:
  """Turns a loss into an eval metric stream.

  Returns ``metric_fn(labels, predictions, features=None) ->
  (per_elem_losses, per_elem_weights)`` whose weighted mean equals the
  reference's ``eval_metric`` (losses_impl.py:837-860): per list for the
  listwise losses, per pair ``[B, L, L]`` for the pairwise losses, per item
  for the pointwise ones. A gumbel key scores its loss on the lists as
  given, as the JAX package's stream does.
  """
  loss_obj = build_loss(loss_key, lambda_weight, name or loss_key, **params)

  def _metric_fn(labels, predictions, features=None):
    predictions = losses_lib._float(predictions)
    labels = losses_lib._float(labels, predictions)
    weights = _weights_from(features, weights_feature_name, predictions)
    if isinstance(loss_obj, losses_lib.SoftmaxLoss):
      # per_list folds the weights and lambda weights into the labels, and
      # for CalibratedSoftmaxLoss appends the virtual anchor: going through
      # precompute/unreduced directly would score plain softmax there, a
      # different objective than the one trained.
      return loss_obj.per_list(labels, predictions, weights=weights)
    losses, loss_weights = loss_obj.unreduced(
        labels, loss_obj.get_logits(predictions))
    weights = loss_obj.normalize_weights(labels, weights) * loss_weights
    return losses, torch.broadcast_to(weights, losses.shape)

  return _metric_fn
