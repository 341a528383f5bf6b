"""String-keyed loss registry and weighted multi-loss factory.

The port's copy of ``ranking_tpu/ops/loss_registry.py`` (the reference's
tensorflow_ranking/python/losses.py): the same ``RankingLossKey`` strings,
``make_loss_fn`` building ``(labels, logits, features=None, generator=None)
-> scalar`` from weighted losses, and ``make_loss_metric_fn`` turning a loss
into a per-list eval stream. ``softmax_loss`` and the four pairwise keys are
ported; every other key raises "not ported yet", as ``build_metric`` does
for its keys. ``yeti_logistic_loss`` is among those: its inputs go through
the Gumbel sampler, which waits for the rest of the loss zoo (the Yeti
lambda weight itself is ported: ``PairwiseLogisticLoss(lambda_weight=
create_yeti_dcg_lambda_weight())``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from ranking_tpu_torch.ops import lambda_weights as lw
from ranking_tpu_torch.ops import losses as losses_lib
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
# weight (the keras YetiLogisticLoss defaults to the neighbor-pair DCG
# weight, the python-generation factory applies none to the yeti key).
NO_LAMBDA = 'no_lambda'

_LOSS_CLASSES: Dict[str, Callable[..., losses_lib.RankingLoss]] = {
    RankingLossKey.PAIRWISE_HINGE_LOSS: losses_lib.PairwiseHingeLoss,
    RankingLossKey.PAIRWISE_LOGISTIC_LOSS: losses_lib.PairwiseLogisticLoss,
    RankingLossKey.PAIRWISE_SOFT_ZERO_ONE_LOSS:
        losses_lib.PairwiseSoftZeroOneLoss,
    RankingLossKey.PAIRWISE_MSE_LOSS: losses_lib.PairwiseMSELoss,
    RankingLossKey.SOFTMAX_LOSS: losses_lib.SoftmaxLoss,
}


def build_loss(
    loss_key: str,
    lambda_weight: Optional[Union[lw.LambdaWeight, str]] = None,
    name: str = '',
    **params: Any,
) -> losses_lib.RankingLoss:
  """Instantiates the loss object behind a key (the softmax and the four
  pairwise losses so far).

  ``params`` are loss-specific constructor arguments (temperature, ...).
  Keys that take no lambda weight ignore it, as in the reference factory.
  ``lambda_weight=NO_LAMBDA`` suppresses any key-specific default lambda
  weight (see NO_LAMBDA).
  """
  if loss_key not in RankingLossKey.all_keys():
    raise ValueError(f'Invalid loss_key: {loss_key!r}. '
                     f'Valid keys: {RankingLossKey.all_keys()}')
  if loss_key not in _LOSS_CLASSES:
    raise NotImplementedError(
        f'loss {loss_key!r} is not ported yet; the PyTorch port has '
        f'{sorted(_LOSS_CLASSES)}')
  kw: Dict[str, Any] = dict(name=name or loss_key, **params)
  if isinstance(lambda_weight, str) and lambda_weight == NO_LAMBDA:
    lambda_weight = None
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
) -> LossFn:
  """Builds ``loss_fn(labels, logits, features=None, generator=None) ->
  scalar``.

  Mirrors tensorflow_ranking/python/losses.py:265-311, including the
  ``'softmax_loss:0.9,sigmoid_cross_entropy_loss:0.1'`` encoded form.
  ``generator`` drives the tie shuffles of the lambda weights; None is
  deterministic. Every loss draws from the one generator in turn (a
  generator is a stream, so there is no per-loss fold as with a JAX key).
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
  loss_objs = [build_loss(k, lambda_weight, name or k, **params)
               for k in loss_keys]

  def _loss_fn(labels, logits, features=None, generator=None):
    logits = torch.as_tensor(logits).to(torch.float32)
    labels = torch.as_tensor(labels, device=logits.device).to(torch.float32)
    weights = _weights_from(features, weights_feature_name, logits)
    total = torch.zeros((), dtype=torch.float32, device=logits.device)
    for i, loss_obj in enumerate(loss_objs):
      value = loss_obj(labels, logits, weights=weights, reduction=reduction,
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
  softmax loss, per pair ``[B, L, L]`` for the pairwise losses.
  """
  loss_obj = build_loss(loss_key, lambda_weight, name or loss_key, **params)

  def _metric_fn(labels, predictions, features=None):
    predictions = torch.as_tensor(predictions).to(torch.float32)
    labels = torch.as_tensor(labels,
                             device=predictions.device).to(torch.float32)
    weights = _weights_from(features, weights_feature_name, predictions)
    if isinstance(loss_obj, losses_lib.SoftmaxLoss):
      return loss_obj.per_list(labels, predictions, weights=weights)
    losses, loss_weights = loss_obj.unreduced(
        labels, loss_obj.get_logits(predictions))
    weights = loss_obj.normalize_weights(labels, weights) * loss_weights
    return losses, torch.broadcast_to(weights, losses.shape)

  return _metric_fn
