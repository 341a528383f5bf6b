"""Trains a listwise ranker on LIBSVM data (MSLR-WEB30K and friends).

The port's ``examples/ranking_libsvm.py``, the counterpart of the
reference's flagship example (tf_ranking_libsvm.py): groups LIBSVM rows by
qid into padded lists, trains a univariate DNN (optionally groupwise
multi-item, or a GAM) scorer with any registered ranking loss under
Adagrad, and reports NDCG@k / MRR on the validation and test splits. On the
card::

  python -m ranking_tpu_torch.examples.ranking_libsvm \\
    --train_path=train.txt --vali_path=vali.txt --test_path=test.txt \\
    --num_features=136 --loss=pairwise_logistic_loss --num_train_steps=1000

``--device=cpu`` runs on the CPU. At ``--dropout=0`` the DNN tower takes
the fused masked-BN kernels on the card; the pairwise losses take the fused
pairwise sums, and every evaluation the sort kernel.
"""

import argparse
import os
from typing import Optional, Sequence

import torch
from torch import nn

# The JAX CLI's keys: PRNGKey(0) draws the initial weights, PRNGKey(1) is
# the key of every train step (the same one each step).
INIT_SEED = 0
STEP_SEED = 1
# in_memory_batches' shuffle seed of the train stream.
TRAIN_STREAM_SEED = 17


def parse_args(argv: Optional[Sequence[str]] = None):
  p = argparse.ArgumentParser()
  p.add_argument('--train_path', required=True)
  p.add_argument('--vali_path', required=True)
  p.add_argument('--test_path', default=None)
  p.add_argument('--output_dir', default='/tmp/ranking_libsvm')
  p.add_argument('--num_features', type=int, default=136)
  p.add_argument('--list_size', type=int, default=100)
  p.add_argument('--batch_size', type=int, default=32)
  p.add_argument('--num_train_steps', type=int, default=100)
  p.add_argument('--learning_rate', type=float, default=0.01)
  p.add_argument('--loss', default='pairwise_logistic_loss')
  p.add_argument('--group_size', type=int, default=1)
  p.add_argument('--scorer', default='dnn', choices=['dnn', 'gam'],
                 help="'gam' = interpretable generalized additive scorer "
                      '(canned GAM estimator counterpart).')
  p.add_argument('--hidden_layer_dims', default='256,128,64')
  p.add_argument('--dropout', type=float, default=0.5)
  p.add_argument('--lambda_ndcg', action='store_true',
                 help='Use an NDCG LambdaWeight (LambdaLoss/LambdaMART).')
  p.add_argument('--eval_every', type=int, default=100)
  p.add_argument('--device', default='cuda', help="'cuda' or 'cpu'.")
  return p.parse_args(argv)


class SplitGAM(nn.Module):
  """True GAM semantics: the packed ``[B, L, F]`` LIBSVM tensor splits into
  F scalar features ``col_000``... each with its own tower
  (make_gam_ranking_estimator counterpart). The ``GAMScorer`` is
  ``gam_scorer`` (flax ``GAMScorer_0``)."""

  def __init__(self, hidden_layer_dims: Sequence[int], num_features: int,
               dropout: float, generator: Optional[torch.Generator] = None):
    super().__init__()
    from ranking_tpu_torch.models import scorers
    self.gam_scorer = scorers.GAMScorer(
        example_hidden_layer_dims=hidden_layer_dims,
        example_widths={f'col_{i:03d}': 1 for i in range(num_features)},
        dropout=dropout, generator=generator)

  def forward(self, context, examples, mask, training=False, generator=None):
    x = examples['float_features']
    feats = {f'col_{i:03d}': x[..., i:i + 1] for i in range(x.shape[-1])}
    return self.gam_scorer(context, feats, mask, training=training,
                           generator=generator)


def build_model(args, generator: Optional[torch.Generator] = None):
  from ranking_tpu_torch.models import groupwise
  from ranking_tpu_torch.models import scorers
  hidden = tuple(int(h) for h in args.hidden_layer_dims.split(','))
  if args.scorer == 'gam':
    return scorers.RankingModel(
        SplitGAM(hidden, args.num_features, args.dropout, generator),
        transform_name='log1p')
  if args.group_size > 1:
    scorer = groupwise.GroupwiseDNNScorer(
        args.group_size * args.num_features, group_size=args.group_size,
        hidden_layer_dims=hidden, dropout=args.dropout, generator=generator)
  else:
    # input_grad=False: the tower input is raw LIBSVM features (nothing
    # trainable upstream), so the fused-BN backward skips its largest
    # write.
    scorer = scorers.DNNScorer(hidden, in_features=args.num_features,
                               dropout=args.dropout, input_grad=False,
                               generator=generator)
  return scorers.RankingModel(scorer=scorer, transform_name='log1p')


def evaluate(eval_step, state, feats, labels, metric_fns, batch_size):
  from ranking_tpu_torch.data.dataset import in_memory_batches
  from ranking_tpu_torch.train import steps
  states = steps.init_metric_states(metric_fns, device=state.device)
  for batch in in_memory_batches(feats, labels, batch_size, epochs=1,
                                 shuffle=False, drop_remainder=False):
    states, _ = eval_step(state.model, batch, states)
  results = steps.metric_results(states)
  values = torch.stack(list(results.values())).cpu().tolist()
  return dict(zip(results, values))


def train(args, state, train_step, eval_step, metric_fns, train_x, train_y,
          vali_x, vali_y):
  """The CLI's loop from ``state``: ``args.num_train_steps`` steps over the
  shuffled train lists, an evaluation every ``args.eval_every`` steps and
  after the last. Returns the state, each step's loss and the evaluations
  ``{step: metrics}``."""
  from ranking_tpu_torch.data.dataset import in_memory_batches
  generator = torch.Generator(state.device)
  losses, evals = [], {}
  step = 0
  for batch in in_memory_batches(train_x, train_y, args.batch_size,
                                 epochs=None, seed=TRAIN_STREAM_SEED):
    # The JAX CLI passes its one key to every step, so each step draws the
    # same dropout masks and tie shuffles.
    generator.manual_seed(STEP_SEED)
    state, metrics = train_step(state, batch, generator)
    losses.append(metrics['loss'].detach())
    step += 1
    if step % args.eval_every == 0 or step == args.num_train_steps:
      vali = evaluate(eval_step, state, vali_x, vali_y, metric_fns,
                      args.batch_size)
      evals[step] = vali
      print(f'step {step}: loss={float(metrics["loss"]):.4f} ' +
            ' '.join(f'{k}={v:.4f}' for k, v in sorted(vali.items())))
    if step >= args.num_train_steps:
      break
  return state, torch.stack(losses).cpu().tolist(), evals


def main(argv: Optional[Sequence[str]] = None):
  """Runs the CLI; returns ``{'state', 'losses', 'vali', 'test'}``: the
  trained state, each step's loss, the evaluations ``{step: metrics}`` and
  the test metrics (None without ``--test_path``)."""
  args = parse_args(argv)
  from ranking_tpu_torch.data import libsvm
  from ranking_tpu_torch.ops import lambda_weights as lw
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.ops import metric_registry
  from ranking_tpu_torch.train import checkpoint
  from ranking_tpu_torch.train import state as state_lib
  from ranking_tpu_torch.train import steps
  from ranking_tpu_torch.utils import fns
  from ranking_tpu_torch.utils.device import resolve_device

  device = resolve_device(args.device)
  print(f'Loading {args.train_path} ...')
  train_x, train_y, _ = libsvm.load_libsvm_lists(
      args.train_path, args.list_size, args.num_features)
  vali_x, vali_y, _ = libsvm.load_libsvm_lists(
      args.vali_path, args.list_size, args.num_features)
  print(f'train queries: {len(train_x)}, vali queries: {len(vali_x)}')

  if len(train_y) < args.batch_size:
    raise SystemExit(
        f'--batch_size {args.batch_size} exceeds the {len(train_y)} query '
        f'lists in {args.train_path}; lower --batch_size')
  model = build_model(args, torch.Generator().manual_seed(INIT_SEED))
  state = state_lib.create_train_state(
      model, state_lib.adagrad(args.learning_rate), device=device)

  lambda_weight = None
  if args.lambda_ndcg:
    lambda_weight = lw.DCGLambdaWeightV2(
        gain_fn=fns.pow_minus_1, rank_discount_fn=fns.log2_inverse,
        normalized=True)
  loss_fn = loss_registry.make_loss_fn(args.loss, lambda_weight=lambda_weight)
  train_step = steps.make_train_step(loss_fn, device=device)

  metric_fns = {
      **{f'ndcg@{k}': metric_registry.make_ranking_metric_fn(
          metric_registry.RankingMetricKey.NDCG, topn=k)
         for k in (1, 5, 10)},
      'mrr': metric_registry.make_ranking_metric_fn(
          metric_registry.RankingMetricKey.MRR),
  }
  eval_step = steps.make_eval_step(metric_fns, device=device)

  state, losses, vali = train(args, state, train_step, eval_step, metric_fns,
                              train_x, train_y, vali_x, vali_y)

  test = None
  if args.test_path:
    test_x, test_y, _ = libsvm.load_libsvm_lists(
        args.test_path, args.list_size, args.num_features)
    test = evaluate(eval_step, state, test_x, test_y, metric_fns,
                    args.batch_size)
    print('test: ' + ' '.join(f'{k}={v:.4f}' for k, v in sorted(test.items())))

  os.makedirs(args.output_dir, exist_ok=True)
  checkpoint.export_params(state, os.path.join(args.output_dir, 'export'))
  print(f'exported params to {args.output_dir}/export')
  return {'state': state, 'losses': losses, 'vali': vali, 'test': test}


if __name__ == '__main__':
  main()
