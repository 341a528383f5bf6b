"""Unbiased LTR from clicks: position-bias two-tower training.

The port's ``examples/unbiased_two_tower.py``. Logged clicks conflate
relevance with exposure (position bias), so training a ranker on raw clicks
learns the logging policy. The position-based model factorizes
``P(click) = P(observe | position) * P(relevant | features)``; in logit
space that is a two-tower sum, a relevance tower over document features
plus an observation tower over the logged position, trained with sigmoid
CE on clicks. At serving time only the relevance tower scores.

It synthesizes a click log with 1/rank^eta position bias, trains (a) a
naive click model and (b) the two-tower model, and reports NDCG@5 of each
relevance scorer against the *true* (hidden) labels: the two-tower model
debiases, the naive model does not. On the card::

  python -m ranking_tpu_torch.examples.unbiased_two_tower --eta=1.5

``--device=cpu`` runs on the CPU.
"""

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn


def parse_args(argv: Optional[Sequence[str]] = None):
  p = argparse.ArgumentParser()
  p.add_argument('--queries', type=int, default=1500)
  p.add_argument('--list_size', type=int, default=20)
  p.add_argument('--num_features', type=int, default=16)
  p.add_argument('--eta', type=float, default=1.5,
                 help='Position-bias severity: P(obs) = (1/rank)^eta.')
  p.add_argument('--batch_size', type=int, default=64)
  p.add_argument('--steps', type=int, default=400)
  p.add_argument('--learning_rate', type=float, default=0.01)
  p.add_argument('--device', default='cuda', help="'cuda' or 'cpu'.")
  return p.parse_args(argv)


def make_click_log(args, seed=0):
  """Synthesizes (features, clicks, positions, true_labels)."""
  rng = np.random.RandomState(seed)
  q, l, f = args.queries, args.list_size, args.num_features
  x = rng.randn(q, l, f).astype(np.float32)
  w = rng.randn(f).astype(np.float32) / np.sqrt(f)
  utility = x @ w
  order = np.argsort(np.argsort(utility, axis=1), axis=1)
  true_labels = (order * 5 // l).astype(np.float32)
  rel_prob = (true_labels / 4.0) * 0.9 + 0.05

  # Logging policy: ranks mostly by the first feature (a weak predictor
  # of utility) with exploration noise. Exposure correlates with
  # x[..., 0], so a naive click model inherits that bias (over-weighting
  # x0); the noise varies each document's position, which is what makes
  # the position/relevance decomposition identifiable (as in real logs
  # with result randomization).
  logged_scores = 1.5 * x[..., 0] + rng.randn(q, l)
  shown_rank = np.argsort(np.argsort(-logged_scores, axis=1), axis=1) + 1
  p_obs = (1.0 / shown_rank) ** args.eta
  clicks = (rng.rand(q, l) < p_obs * rel_prob).astype(np.float32)
  return x, clicks, shown_rank.astype(np.int32), true_labels


class TwoTower(nn.Module):
  """Relevance tower (``relevance``, a ``DNNScorer`` without batch norm) +
  positional observation tower (``position_bias``, an embedding of the
  logged position; the PBM factorization); ``use_position`` False = the
  naive click model."""

  def __init__(self, use_position: bool, list_size: int, num_features: int,
               generator: Optional[torch.Generator] = None):
    super().__init__()
    from ranking_tpu_torch.models import embeddings
    from ranking_tpu_torch.models import scorers
    self.use_position = use_position
    self.relevance = scorers.DNNScorer(
        (64, 32), in_features=num_features, dropout=0.0,
        use_batch_norm=False, generator=generator)
    if use_position:
      self.position_bias = embeddings.Embed(list_size + 2, 1,
                                            generator=generator)

  def forward(self, context, examples, mask, training=False, generator=None):
    rel = self.relevance({}, {'x': examples['x']}, mask, training=training)
    if not self.use_position:
      return rel
    return rel + self.position_bias(examples['position'])[..., 0]


def _batch(x, positions, labels, idx, list_size):
  from ranking_tpu_torch.data.batch import RankingBatch
  return RankingBatch(
      context={},
      examples={'x': torch.from_numpy(x[idx]),
                'position': torch.from_numpy(positions[idx])},
      labels=torch.from_numpy(labels[idx]),
      mask=torch.ones((len(idx), list_size), dtype=torch.bool))


def make_state(args, use_position, seed, device):
  """The model (initial draws from ``seed``, as the JAX CLI's
  ``PRNGKey(seed)``) and its Adam state on ``device``."""
  from ranking_tpu_torch.train import state as state_lib
  model = TwoTower(use_position, args.list_size, args.num_features,
                   generator=torch.Generator().manual_seed(seed))
  return state_lib.create_train_state(
      model, state_lib.adam(args.learning_rate), device=device)


def train_model(args, state, x, clicks, positions, split, seed):
  """``args.steps`` steps of sigmoid CE on clicks from ``state``, each on
  ``args.batch_size`` lists drawn with replacement from the first
  ``split`` queries. Returns the state and each step's loss."""
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.train import steps
  loss_fn = loss_registry.make_loss_fn(
      loss_registry.RankingLossKey.SIGMOID_CROSS_ENTROPY_LOSS)
  step = steps.make_train_step(loss_fn, device=state.device)
  rng = np.random.RandomState(seed)
  generator = torch.Generator(state.device)
  losses = []
  for _ in range(args.steps):
    idx = rng.randint(0, split, size=args.batch_size)
    # The JAX CLI passes its one key, PRNGKey(seed + 1), to every step.
    generator.manual_seed(seed + 1)
    state, metrics = step(state, _batch(x, positions, clicks, idx,
                                        args.list_size), generator)
    losses.append(metrics['loss'].detach())
  return state, torch.stack(losses).cpu().tolist()


def true_ndcg(args, state, x, true_labels, split):
  """NDCG@5 of the relevance scores on the held-out split against the true
  labels: position set to a constant so the observation tower contributes
  a constant offset (rank-invariant), i.e. scores order by relevance
  alone."""
  from ranking_tpu_torch.ops import metric_registry
  device = state.device
  n = args.queries - split
  with torch.no_grad():
    scores = state.model(
        {}, {'x': torch.from_numpy(x[split:]).to(device),
             'position': torch.zeros((n, args.list_size), dtype=torch.int32,
                                     device=device)},
        torch.ones((n, args.list_size), dtype=torch.bool, device=device),
        training=False)
    value = metric_registry.compute_mean(
        metric_registry.RankingMetricKey.NDCG,
        torch.from_numpy(true_labels[split:]).to(device), scores, topn=5)
  return float(value)


def main(argv: Optional[Sequence[str]] = None):
  """Runs the CLI; returns (naive, debiased) true NDCG@5."""
  args = parse_args(argv)
  from ranking_tpu_torch.utils.device import resolve_device
  device = resolve_device(args.device)

  x, clicks, positions, true_labels = make_click_log(args)
  split = args.queries * 4 // 5

  naive_state, _ = train_model(args, make_state(args, False, 0, device), x,
                               clicks, positions, split, seed=0)
  tt_state, _ = train_model(args, make_state(args, True, 0, device), x,
                            clicks, positions, split, seed=0)
  naive = true_ndcg(args, naive_state, x, true_labels, split)
  debiased = true_ndcg(args, tt_state, x, true_labels, split)
  print(json.dumps({
      'eta': args.eta,
      'naive_click_model_true_ndcg@5': round(naive, 4),
      'two_tower_debiased_true_ndcg@5': round(debiased, 4),
  }))
  return naive, debiased


if __name__ == '__main__':
  main()
