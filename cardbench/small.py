"""Each cell at a size the CPU tests can hold: the cell's own configuration
and traffic files with their sizes cut (widths too: these sizes stand for
nothing, they only drive the harness's code paths)."""

from __future__ import annotations

import os

from cardbench import harness

CONFIG_CUTS = {
    'dnn': dict(num_features=20, hidden_layer_dims=[32, 16, 8]),
    'encoder': dict(hidden_size=32, intermediate_size=64,
                    num_hidden_layers=2, num_attention_heads=4,
                    vocab_size=2000, max_position_embeddings=64),
}
TRAFFIC_CUTS = {
    'train_lambdarank': dict(batch_size=4, list_size=16, min_docs=3,
                             max_docs=16, pool_lists=40, steps_per_dispatch=3),
    'train_softmax': dict(batch_size=2, list_size=3, min_docs=3, max_docs=3,
                          seq_len=16, min_tokens=6, max_tokens=16,
                          pool_lists=16, steps_per_dispatch=2),
    'serve_rerank': dict(min_docs=7, max_docs=7, seq_len=16, min_tokens=6,
                         max_tokens=16, pool_rounds=6, check_requests=4),
}


def ctx(cell: str, seed: int = 2**31 + 7, seconds: float = 0.5,
        trace: bool = False):
  """The cell's run context on the CPU at the small sizes."""
  bench = harness.benchmark()
  w = harness.workload(bench, cell)
  config = harness.load_json(os.path.join(
      harness.ROOT, harness.config_entry(bench, w['config'])['file']))
  traffic = harness.load_json(os.path.join(
      harness.HERE, 'traffic', f"{w['traffic']}.json"))
  config = dict(config, **CONFIG_CUTS[config['family']])
  traffic = dict(traffic, **TRAFFIC_CUTS[w['traffic']])
  return bench, harness.make_ctx(bench, cell, seed, seconds, trace, 'cpu',
                                 config=config, traffic=traffic)
