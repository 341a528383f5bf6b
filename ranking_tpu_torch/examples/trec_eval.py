"""Evaluates a TREC run file against TREC qrels with the ranking metric suite.

The port's ``examples/trec_eval.py``: inner-joins qrels and run on
(query_id, doc_id) and streams the joined per-query lists through the
requested metrics (``data/trec.evaluate_run``), on the card::

  python -m ranking_tpu_torch.examples.trec_eval \\
    --qrels=trec_qrel.txt --run=trec_run.txt \\
    --metrics='ndcg@1,ndcg@5,ndcg,mrr,mrr@10'

Graded datasets (Web30K/Istella) use a binary cut for MRR, e.g.
``--metrics='ndcg@5,mrr:rel>=3,mrr@10:rel>=3'``. ``--device=cpu`` runs on
the CPU.
"""

import argparse
import json
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None):
  p = argparse.ArgumentParser()
  p.add_argument('--qrels', required=True, help='TREC qrels file')
  p.add_argument('--run', required=True, help='TREC run file')
  p.add_argument('--metrics', default='ndcg@1,ndcg@5,ndcg,mrr,mrr@10',
                 help='comma list of key[@topn][:rel>=T] specs')
  p.add_argument('--batch_size', type=int, default=128)
  p.add_argument('--device', default='cuda', help="'cuda' or 'cpu'.")
  return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
  """Runs the CLI; returns ``{metric_name: value}``."""
  args = parse_args(argv)
  from ranking_tpu_torch.data import trec
  from ranking_tpu_torch.utils.device import resolve_device

  device = resolve_device(args.device)

  results = trec.evaluate_run(args.qrels, args.run,
                              metrics=args.metrics,
                              batch_size=args.batch_size,
                              device=device)
  for name, value in results.items():
    print(f'{name}={value:.4f}')
  print(json.dumps(results))
  return results


if __name__ == '__main__':
  main()
