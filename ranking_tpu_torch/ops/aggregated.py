"""Cross-batch aggregated metrics grouped by query id (host-side).

The port's copy of ``ranking_tpu/ops/aggregated.py``, the analog of
TFR-BERT's aggregated evaluation
(tensorflow_ranking/extension/premade/tfrbert_task.py:238-344):
predictions from many eval batches are pooled by query id, so that a query
whose documents were split across batches (or truncated lists) is scored
once over its whole candidate set, and the per-query metric values are
averaged. The groups are padded into one ``[Q, Lmax]`` batch and scored by
the standard metric fns on the device the caller names: there is no second
metric implementation.

Also writes the predictions CSV (tfrbert_task.py:332-344).
"""

from __future__ import annotations

import csv
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ranking_tpu_torch.ops import metric_registry
from ranking_tpu_torch.utils import list_ops
from ranking_tpu_torch.utils.device import DeviceLike, resolve_device


class PredictionAccumulator:
  """Collects (query_id, relevance, score) triples across eval batches."""

  def __init__(self):
    self._qids: List = []
    self._labels: List[float] = []
    self._scores: List[float] = []

  def add_batch(self, query_ids, labels, scores, mask=None) -> None:
    """query_ids: [B] or [B, L]; labels/scores: [B, L]; mask: [B, L]
    (numpy arrays or CPU tensors)."""
    query_ids = np.asarray(query_ids)
    labels = np.asarray(labels)
    scores = np.asarray(scores)
    if mask is None:
      mask = labels >= 0
    mask = np.asarray(mask, bool)
    if query_ids.ndim == 1:
      query_ids = np.repeat(query_ids[:, None], labels.shape[1], axis=1)
    self._qids.extend(query_ids[mask].tolist())
    self._labels.extend(labels[mask].astype(float).tolist())
    self._scores.extend(scores[mask].astype(float).tolist())

  def grouped(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (labels [Q, Lmax], scores [Q, Lmax], qids [Q]), -1 padded."""
    by_qid: Dict = {}
    order = []
    for q, l, s in zip(self._qids, self._labels, self._scores):
      if q not in by_qid:
        by_qid[q] = []
        order.append(q)
      by_qid[q].append((l, s))
    lmax = max((len(v) for v in by_qid.values()), default=1)
    labels = np.full((len(order), lmax), -1.0, np.float32)
    scores = np.full((len(order), lmax), -1e6, np.float32)
    for i, q in enumerate(order):
      for j, (l, s) in enumerate(by_qid[q]):
        labels[i, j] = l
        scores[i, j] = s
    return labels, scores, np.asarray(order)

  def compute(self, metric_specs: Mapping[str, Tuple[str, Optional[int]]],
              device: DeviceLike = 'cuda') -> Dict[str, float]:
    """metric_specs: display name -> (metric_key, topn). The grouped batch
    goes to ``device`` once and every metric reads one shared sort order
    (``list_ops.shared_sort_scope``, as in the eval step)."""
    device = resolve_device(device)
    grouped_labels, grouped_scores, _ = self.grouped()
    labels = torch.from_numpy(grouped_labels).to(device)
    scores = torch.from_numpy(grouped_scores).to(device)
    out = {}
    with list_ops.shared_sort_scope():
      for name, (key, topn) in metric_specs.items():
        out[name] = metric_registry.compute_mean(key, labels, scores,
                                                 topn=topn)
    values = torch.stack(list(out.values())).cpu().tolist() if out else []
    return dict(zip(out, values))

  def dump_csv(self, path: str) -> None:
    with open(path, 'w', newline='') as f:
      writer = csv.writer(f)
      writer.writerow(['query_id', 'relevance', 'score'])
      for q, l, s in zip(self._qids, self._labels, self._scores):
        writer.writerow([q, l, s])
