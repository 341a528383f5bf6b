"""ListNet's ``softmax_loss``, the pipeline's default."""

from cardbench.reference import ranking

reference = ranking.softmax_loss


def program():
  from ranking_tpu_torch.ops import loss_registry
  return loss_registry.make_loss_fn('softmax_loss')
