"""LIBSVM ranking-format ingestion (MSLR-WEB30K and friends).

The port's copy of ``ranking_tpu/data/libsvm.py``, with the semantics of
the reference's loader (examples/tf_ranking_libsvm.py:137-195): rows
``label qid:<id> f1:v1 f2:v2 ...`` are grouped by qid into
``[num_queries, list_size, num_features]`` arrays, labels padded with -1,
lists cut to their first ``list_size`` documents. Feature indices are
1-based; missing features are 0.

``load_libsvm_lists`` parses with the native C++ parser (``data/native``)
unless ``use_native=False``. Where the native parser was asked for and
cannot be built or loaded, it raises; it does not fall back to the Python
parser as the JAX package does.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np


def iter_libsvm_lines(path: str) -> Iterator[Tuple[float, str, dict]]:
  """Yields (label, qid, {feature_index: value}) per row."""
  with open(path) as f:
    for line in f:
      line = line.split('#')[0].strip()
      if not line:
        continue
      parts = line.split()
      label = float(parts[0])
      qid = None
      feats = {}
      for tok in parts[1:]:
        key, _, val = tok.partition(':')
        if key == 'qid':
          qid = val
        else:
          feats[int(key)] = float(val)
      if qid is None:
        raise ValueError(f'Row without qid in {path}: {line[:80]}')
      yield label, qid, feats


def load_libsvm_lists(
    path: str,
    list_size: int,
    num_features: int,
    padding_label: float = -1.0,
    use_native: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
  """Loads one LIBSVM file into padded listwise arrays.

  Returns:
    features: ``[Q, list_size, num_features]`` float32
    labels: ``[Q, list_size]`` float32, padded with ``padding_label``
    qids: ``[Q]`` array of qid strings (lists in first-seen qid order,
      documents in file order; a list keeps its first ``list_size``).
  """
  if use_native:
    from ranking_tpu_torch.data import native
    return native.load_libsvm_lists(path, list_size, num_features,
                                    padding_label)
  qid_order = []
  by_qid = {}
  for label, qid, feats in iter_libsvm_lines(path):
    if qid not in by_qid:
      by_qid[qid] = []
      qid_order.append(qid)
    by_qid[qid].append((label, feats))

  num_queries = len(qid_order)
  features = np.zeros((num_queries, list_size, num_features), np.float32)
  labels = np.full((num_queries, list_size), padding_label, np.float32)
  for qi, qid in enumerate(qid_order):
    for di, (label, feats) in enumerate(by_qid[qid][:list_size]):
      labels[qi, di] = label
      for fidx, val in feats.items():
        if 1 <= fidx <= num_features:
          features[qi, di, fidx - 1] = val
  return features, labels, np.asarray(qid_order)


def infer_num_features(path: str, sample_rows: Optional[int] = 1000) -> int:
  """Largest feature index in the first ``sample_rows`` rows."""
  max_idx = 0
  for i, (_, _, feats) in enumerate(iter_libsvm_lines(path)):
    if feats:
      max_idx = max(max_idx, max(feats))
    if sample_rows is not None and i + 1 >= sample_rows:
      break
  return max_idx


# Label thresholds over each list's noisy score quantiles, MSLR's skew
# (about 50/30/12/5/3% for labels 0..4).
_LABEL_QUANTILES = (0.50, 0.80, 0.92, 0.97)


def write_random_lists(path: str, num_queries: int, num_features: int,
                       min_docs: int, max_docs: int, seed: int = 0) -> int:
  """Writes a LIBSVM file of ``num_queries`` random lists for tests and
  smoke runs; returns the rows written.

  Each list has a length uniform in ``[min_docs, max_docs]``; every row
  lists all ``num_features`` features (normal, 4 decimals), as MSLR-WEB30K
  rows do, and a graded label 0..4 from per-list quantiles of a noisy
  linear score of the features, so that a model can learn from them. The
  file depends on the arguments only.
  """
  rng = np.random.RandomState(seed)
  w = rng.randn(num_features) / np.sqrt(num_features)
  counts = rng.randint(min_docs, max_docs + 1, size=num_queries)
  x = np.round(rng.randn(int(counts.sum()), num_features), 4)
  score = x @ w + rng.randn(len(x))
  qid = np.repeat(np.arange(1, num_queries + 1), counts)
  labels = np.zeros(len(x))
  start = 0
  for n in counts:
    s = score[start:start + n]
    labels[start:start + n] = np.searchsorted(
        np.quantile(s, _LABEL_QUANTILES), s, side='right')
    start += n
  fmt = '%d qid:%d ' + ' '.join(f'{j}:%.4f'
                                for j in range(1, num_features + 1))
  np.savetxt(path, np.column_stack([labels, qid, x]), fmt=fmt)
  return len(x)
