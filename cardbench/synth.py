"""Inputs drawn by numpy from the seed: MSLR-shaped lists and BERT token
sequences. Everything is made in memory; nothing is written to disk.

``mslr_lists`` is the benchmark's frozen copy of the repository's
MSLR-WEB30K-shaped generator (graded 0..4 labels skewed toward 0 by
per-list quantiles of a fixed nonlinear score of the 136 features), drawn
with numpy's PCG64 in float32 so that a large set costs little set-up.
"""

from __future__ import annotations

import numpy as np

# Graded-label thresholds over each list's score quantiles: about 50 / 30 /
# 12 / 5 / 3 % of the documents at labels 0..4, MSLR's skew.
LABEL_QUANTILES = (0.50, 0.80, 0.92, 0.97)
# The ground-truth score's weights: fixed, the same for every seed.
_TRUTH_SEED = 1234


def rng(seed: int, stream: int = 0) -> np.random.Generator:
  """The numpy generator of one stream of a run's seed."""
  return np.random.default_rng([int(seed) % 2**63, stream])


def _truth(num_features: int):
  r = np.random.RandomState(_TRUTH_SEED)
  w1 = (r.randn(num_features) / np.sqrt(num_features)).astype(np.float32)
  w2 = (r.randn(16) / 4.0).astype(np.float32)
  ia = r.permutation(num_features)[:8]
  ib = r.permutation(num_features)[:8]
  return w1, w2, ia, ib


def doc_counts(gen: np.random.Generator, num_lists: int, low: int,
               high: int) -> np.ndarray:
  """Valid documents a list: every count of ``low..high`` in turn, as
  evenly as ``num_lists`` allows, in a seeded order. Every seed thus gets
  the same multiset of list lengths, and so the same work."""
  span = np.arange(low, high + 1)
  reps = -(-num_lists // len(span))
  counts = np.tile(span, reps)[:num_lists]
  return gen.permutation(counts)


def mslr_lists(seed: int, num_lists: int, list_size: int, num_features: int,
               min_docs: int, max_docs: int):
  """``(features [Q, L, F] float32, labels [Q, L] float32)``: documents past
  a list's length are zero features and label -1."""
  gen = rng(seed, 1)
  w1, w2, ia, ib = _truth(num_features)
  feats = gen.standard_normal((num_lists, list_size, num_features),
                              dtype=np.float32)
  counts = doc_counts(gen, num_lists, min_docs, min(max_docs, list_size))
  scores = feats @ w1
  scores += np.clip(feats[..., :16], -3, 3) ** 2 @ w2
  scores += 0.5 * (feats[..., ia] * feats[..., ib]).sum(-1)
  scores += gen.standard_normal(scores.shape, dtype=np.float32)
  valid = np.arange(list_size)[None, :] < counts[:, None]
  feats[~valid] = 0.0
  labels = np.full((num_lists, list_size), -1.0, np.float32)
  for q in range(num_lists):
    s = scores[q, :counts[q]]
    cut = np.quantile(s, LABEL_QUANTILES)
    labels[q, :counts[q]] = np.searchsorted(cut, s, side='right')
  return feats, labels


def bert_lists(seed: int, num_lists: int, docs: np.ndarray, list_size: int,
               seq_len: int, min_tokens: int, max_tokens: int,
               vocab_size: int, query_tokens=(4, 16), cls_id: int = 101,
               sep_id: int = 102):
  """BERT inputs of ``num_lists`` lists with ``docs[i]`` documents each,
  padded to ``list_size``: ``(input_ids, input_mask, segment_ids)`` int64
  ``[Q, L, T]`` and labels ``[Q, L]`` float32 (-1 for absent documents).

  Each document is ``[CLS] query [SEP] document [SEP]`` of ``min_tokens ..
  max_tokens`` valid tokens (every length in turn, in a seeded order),
  the query of its list's length; segment 0 up to the first [SEP], 1
  after; pad id 0 with mask 0. Ordinary ids avoid the first 1,000 (BERT's
  special and unused tokens). Labels are graded 0..4 at about MSLR's
  skew."""
  gen = rng(seed, 2)
  ids = np.zeros((num_lists, list_size, seq_len), np.int64)
  mask = np.zeros_like(ids)
  seg = np.zeros_like(ids)
  labels = np.full((num_lists, list_size), -1.0, np.float32)
  n_docs = int(np.sum(docs))
  lengths = doc_counts(gen, n_docs, min_tokens, max_tokens)
  body = gen.integers(1000, vocab_size, size=(num_lists, list_size, seq_len))
  grades = np.searchsorted(np.asarray(LABEL_QUANTILES),
                           gen.random(n_docs), side='right')
  k = 0
  for q in range(num_lists):
    q_len = int(gen.integers(query_tokens[0], query_tokens[1] + 1))
    for d in range(int(docs[q])):
      t = int(lengths[k])
      q_here = min(q_len, t - 4)
      row = body[q, d, :t].copy()
      row[0] = cls_id
      row[1 + q_here] = sep_id
      row[t - 1] = sep_id
      row[1:1 + q_here] = body[q, 0, 1:1 + q_here]   # the list's query
      ids[q, d, :t] = row
      mask[q, d, :t] = 1
      seg[q, d, 2 + q_here:t] = 1
      labels[q, d] = grades[k]
      k += 1
  return ids, mask, seg, labels
