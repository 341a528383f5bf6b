"""TREC run/qrels evaluation (the RD-Suite benchmark surface).

The port's copy of ``ranking_tpu/data/trec.py``, the reference's RD-Suite
evaluation recipe
(tensorflow_ranking/datasets/rd_suite/RD_Suite_Eval_Script.ipynb): a TREC
``qrels`` file (``query_id 0 doc_id relevance``) is inner-joined with a
TREC ``run`` file (``query_id Q0 doc_id rank score run_id``) on
(query_id, doc_id); the joined per-query lists are padded into batches
(labels -1) and streamed through the ranking metrics on the device the
caller names. Join semantics match the notebook's ``qrel.merge(run)``:
documents present in only one of the two files are dropped, and queries
follow qrels-file first-appearance order.

List sizes are bucketed to powers of two before padding, so that a whole
evaluation sees O(log L) batch shapes instead of one per list length.
"""

from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, Iterator, List, Optional,
                    Sequence, Tuple)

import numpy as np

import torch

from ranking_tpu_torch.ops import metric_registry
from ranking_tpu_torch.utils import list_ops
from ranking_tpu_torch.utils.device import DeviceLike, resolve_device

PADDING_LABEL = -1.0


def read_qrels(path: str) -> Dict[str, Dict[str, float]]:
  """Reads a TREC qrels file: ``query_id <it> doc_id relevance``.

  Returns ``{query_id: {doc_id: relevance}}`` with queries in file
  first-appearance order (dicts preserve insertion order). A repeated
  (query, doc) pair keeps the last judgment.
  """
  qrels: Dict[str, Dict[str, float]] = {}
  with open(path) as f:
    for ln, line in enumerate(f, 1):
      parts = line.split()
      if not parts:
        continue
      if len(parts) != 4:
        raise ValueError(f'{path}:{ln}: expected 4 fields '
                         f'(query_id 0 doc_id relevance), got {len(parts)}')
      qid, _, doc, rel = parts
      qrels.setdefault(qid, {})[doc] = float(rel)
  return qrels


def read_run(path: str) -> Dict[str, List[Tuple[str, float]]]:
  """Reads a TREC run file: ``query_id Q0 doc_id rank score run_id``.

  Returns ``{query_id: [(doc_id, score), ...]}`` in file order (the rank
  column is ignored; scores are authoritative, as in the reference
  notebook).
  """
  run: Dict[str, List[Tuple[str, float]]] = {}
  with open(path) as f:
    for ln, line in enumerate(f, 1):
      parts = line.split()
      if not parts:
        continue
      if len(parts) != 6:
        raise ValueError(f'{path}:{ln}: expected 6 fields '
                         f'(query_id Q0 doc_id rank score run_id), '
                         f'got {len(parts)}')
      qid, _, doc, _, score, _ = parts
      run.setdefault(qid, []).append((doc, float(score)))
  return run


def write_run(path: str, scores_by_query: Dict[str, Dict[str, float]],
              run_id: str = 'ranking_tpu') -> None:
  """Writes predictions as a TREC run file (docs ranked by descending score).

  The inverse of :func:`read_run`; the analog of the reference's
  host-side prediction dump (extension/premade/tfrbert_task.py:332-344).
  The default ``run_id`` is the JAX package's, so that both write the
  same file.
  """
  with open(path, 'w') as f:
    for qid, doc_scores in scores_by_query.items():
      ranked = sorted(doc_scores.items(), key=lambda kv: -kv[1])
      for rank, (doc, score) in enumerate(ranked, 1):
        f.write(f'{qid} Q0 {doc} {rank} {score:.6f} {run_id}\n')


def merged_lists(
    qrels: Dict[str, Dict[str, float]],
    run: Dict[str, List[Tuple[str, float]]],
) -> Iterator[Tuple[str, np.ndarray, np.ndarray]]:
  """Inner-joins qrels and run into per-query (labels, scores) arrays.

  Yields ``(query_id, labels [n], scores [n])`` for each query with at
  least one judged-and-retrieved document, in qrels order. Documents
  judged but not retrieved, or retrieved but not judged, are dropped —
  the notebook's ``merge`` semantics (document this to users: it differs
  from trec_eval, which scores unretrieved judged docs as misses).

  Within a query, documents follow the qrels (left-frame) row order —
  matching the notebook's ``qrel.merge(run)``, whose output preserves the
  left frame's order. This matters under score ties: ``sort_by_scores``
  breaks ties by list position, so a run-order join would yield different
  metric values than the notebook when scores tie. A doc repeated within
  one query's run keeps its first score (run files list each doc once;
  trec_eval rejects duplicates).
  """
  for qid, judged in qrels.items():
    retrieved = run.get(qid)
    if not retrieved:
      continue
    by_doc: Dict[str, float] = {}
    for doc, score in retrieved:
      by_doc.setdefault(doc, score)
    labels = []
    scores = []
    for doc, rel in judged.items():
      if doc in by_doc:
        labels.append(rel)
        scores.append(by_doc[doc])
    if labels:
      yield qid, np.asarray(labels, np.float32), np.asarray(scores, np.float32)


def _bucket(n: int, min_size: int = 8) -> int:
  size = min_size
  while size < n:
    size *= 2
  return size


def padded_batches(
    lists: Iterator[Tuple[str, np.ndarray, np.ndarray]],
    batch_size: int = 128,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
  """Pads per-query lists into ``(labels [B, L], scores [B, L])`` batches.

  L is the power-of-two bucket of the longest list in the batch; label
  padding is -1 (invalid), score padding 0 (metrics reset invalid
  predictions regardless of value, ops/metrics.py base semantics).
  """
  buf: List[Tuple[np.ndarray, np.ndarray]] = []

  def _emit(buf):
    size = _bucket(max(len(l) for l, _ in buf))
    labels = np.full((len(buf), size), PADDING_LABEL, np.float32)
    scores = np.zeros((len(buf), size), np.float32)
    for i, (l, s) in enumerate(buf):
      labels[i, :len(l)] = l
      scores[i, :len(s)] = s
    return labels, scores

  for _, labels, scores in lists:
    buf.append((labels, scores))
    if len(buf) == batch_size:
      yield _emit(buf)
      buf = []
  if buf:
    yield _emit(buf)


@dataclasses.dataclass(frozen=True)
class MetricSpec:
  """One parsed metric spec: key, optional cutoff, optional binary threshold.

  ``threshold`` reproduces the notebook's ``BinaryMRRMetric``: labels are
  binarized as ``label >= threshold`` before the metric (used for graded
  datasets like Web30K/Istella where MRR needs a relevance cut).
  """

  key: str
  topn: Optional[int] = None
  threshold: Optional[float] = None

  @property
  def name(self) -> str:
    name = self.key
    if self.threshold is not None:
      name += f'[rel>={self.threshold:g}]'
    if self.topn is not None:
      name += f'@{self.topn}'
    return name


def parse_metric_specs(specs: str) -> List[MetricSpec]:
  """Parses ``'ndcg@5,mrr@10,mrr:rel>=3'`` into :class:`MetricSpec` s.

  Grammar per item: ``key[@topn][:rel>=threshold]``. Keys are validated
  against the metric registry.
  """
  out = []
  valid = set(metric_registry.RankingMetricKey.all_keys())
  for item in specs.split(','):
    item = item.strip()
    if not item:
      continue
    threshold = None
    if ':' in item:
      item, _, cond = item.partition(':')
      if not cond.startswith('rel>='):
        raise ValueError(f'Bad metric condition {cond!r} (want rel>=X)')
      threshold = float(cond[len('rel>='):])
    topn = None
    if '@' in item:
      item, _, n = item.partition('@')
      topn = int(n)
    if item not in valid:
      raise ValueError(f'Unknown metric key {item!r}. Valid: {sorted(valid)}')
    out.append(MetricSpec(key=item, topn=topn, threshold=threshold))
  return out


def evaluate_run(
    qrels_path: str,
    run_path: str,
    metrics: Sequence[MetricSpec] | str = 'ndcg@1,ndcg@5,ndcg,mrr,mrr@10',
    batch_size: int = 128,
    device: DeviceLike = 'cuda',
) -> Dict[str, float]:
  """Evaluates a TREC run against qrels with the ranking metric suite.

  The end-to-end analog of the RD-Suite eval script: returns
  ``{metric_name: weighted-mean value}`` over all judged-and-retrieved
  queries. ``metrics`` is a spec string (see :func:`parse_metric_specs`)
  or a sequence of :class:`MetricSpec`. The batches and the metric states
  live on ``device``.
  """
  device = resolve_device(device)
  if isinstance(metrics, str):
    metrics = parse_metric_specs(metrics)
  if not metrics:
    raise ValueError('evaluate_run: no metrics requested')
  fns: Dict[str, Tuple[MetricSpec, Callable]] = {}
  for spec in metrics:
    if spec.name in fns:
      raise ValueError(f'Duplicate metric spec {spec.name!r}; each '
                       'requested metric must render to a distinct name')
    fns[spec.name] = (spec, metric_registry.make_ranking_metric_fn(
        spec.key, topn=spec.topn))
  states = {name: metric_registry.MeanState.zero(device) for name in fns}

  qrels = read_qrels(qrels_path)
  run = read_run(run_path)
  for labels, scores in padded_batches(merged_lists(qrels, run), batch_size):
    # One transfer a batch; the scope shares each distinct
    # (scores, labels-variant) sort across every metric that needs it
    # (as in the eval step: list_ops.shared_sort_scope).
    scores_t = torch.from_numpy(scores).to(device)
    labels_t = torch.from_numpy(labels).to(device)
    thresholded: Dict[float, Any] = {}
    with list_ops.shared_sort_scope():
      for name, (spec, fn) in fns.items():
        batch_labels = labels_t
        if spec.threshold is not None:
          # Binarize judged docs only; padding stays -1 (invalid).
          if spec.threshold not in thresholded:
            thresholded[spec.threshold] = torch.where(
                labels_t >= 0,
                (labels_t >= spec.threshold).to(torch.float32),
                labels_t)
          batch_labels = thresholded[spec.threshold]
        values, weights = fn(batch_labels, scores_t)
        states[name] = states[name].update(values, weights)
  results = torch.stack([s.result() for s in states.values()]).cpu().tolist()
  return dict(zip(states, results))
