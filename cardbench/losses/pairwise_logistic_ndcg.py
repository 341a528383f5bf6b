"""LambdaRank as ``ranking_libsvm --lambda_ndcg`` trains it:
``pairwise_logistic_loss`` under the normalized NDCG lambda weight of
LambdaLoss (``DCGLambdaWeightV2``: gain 2^l - 1, log2 discount)."""

from cardbench.reference import ranking

reference = ranking.pairwise_logistic_ndcg_loss


def program():
  from ranking_tpu_torch.ops import lambda_weights, loss_registry
  from ranking_tpu_torch.utils import fns
  weight = lambda_weights.DCGLambdaWeightV2(
      gain_fn=fns.pow_minus_1, rank_discount_fn=fns.log2_inverse,
      normalized=True)
  return loss_registry.make_loss_fn('pairwise_logistic_loss',
                                    lambda_weight=weight)
