"""Operations and bytes that the inputs need, counted from shapes.

The yardstick of every share of a peak or a roofline. It counts the work of
the valid documents and tokens only: what these inputs need, not what a
kernel happens to compute (padding rows, padded tokens, a product done in
three passes). So a later change that skips padding shows as a gain, and no
count goes stale when the implementation changes. Nothing here reads the
program.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from cardbench import peaks

F32 = 4  # bytes of a float32


def bound_seconds(flops: float, byte_count: float, sfu_ops: float = 0.0,
                  flops_per_s: float = peaks.TF32_FLOPS) -> float:
  """The least time the card could take: the larger of the operations over
  the peak rate, the special-function results over theirs, and the bytes
  over the HBM rate."""
  return max(flops / flops_per_s, sfu_ops / peaks.SFU_OPS,
             byte_count / peaks.HBM_BYTES_PER_S)


# -- the feed-forward scorer -------------------------------------------------


def _products(dims: Sequence[int]) -> list:
  return [a * b for a, b in zip(dims[:-1], dims[1:])]


def dnn_forward_flops(n_docs: float, dims: Sequence[int]) -> float:
  """Multiply-adds of the dense layers ``dims[0] -> ... -> dims[-1]`` over
  ``n_docs`` valid documents, two operations each."""
  return 2.0 * n_docs * sum(_products(dims))


def dnn_train_flops(n_docs: float, dims: Sequence[int]) -> float:
  """Forward, weight gradients of every layer and input gradients of every
  layer but the first (its input is raw data, whose gradient nothing
  needs)."""
  prods = _products(dims)
  return 2.0 * n_docs * (2 * sum(prods) + sum(prods[1:]))


def tower_train_work(n_docs: float, dims: Sequence[int]):
  """(flops, bytes) of the batch-normalized tower's training function,
  ``dims`` its input and hidden widths (no output layer): the forward, the
  backward of every layer (weight gradients everywhere, input gradients
  above the first layer), counted as one function: each input byte read
  once (rows, parameters, the top activation's gradient) and each output
  byte written once (top activation, parameter gradients, batch moments)."""
  prods = _products(dims)
  flops = 2.0 * n_docs * (2 * sum(prods) + sum(prods[1:]))
  params = sum(prods) + 3 * sum(dims[1:])      # W, b, gamma, beta per layer
  byte_count = F32 * (n_docs * dims[0]           # rows in
                      + 2 * n_docs * dims[-1]    # top gradient in, output out
                      + 2 * params               # parameters in, grads out
                      + 2 * sum(dims[1:]))       # batch means and variances
  return flops, byte_count


# -- pairwise losses ---------------------------------------------------------

# Float operations and special-function results a preference pair needs:
# the lambda weight of the mode, and the loss forward or backward.
PAIR_WORK = {
    'weight': {'none': (1, 0), 'labeldiff': (3, 0), 'dcg': (4, 0)},
    'forward': {'logistic': (9, 2), 'hinge': (4, 0)},
    'backward': {'logistic': (5, 2), 'hinge': (4, 0)},
}


def pairwise_work(labels: np.ndarray, mask: np.ndarray, loss: str = 'logistic',
                  weight: str = 'dcg', backward: bool = False):
  """(flops, sfu_ops, bytes) of one pairwise loss call over ``[B, L]``
  labels: every valid pair compared once, the preference pairs'
  weight and loss, each valid document's inputs read once (labels, logits,
  and for a DCG weight its gain and rank) and the output written once (a
  scalar a list; the logits' gradient backward)."""
  mask = mask.astype(bool)
  n = mask.sum(axis=1).astype(np.float64)
  lab = np.where(mask, labels, -np.inf)
  pref = float(((lab[:, :, None] > lab[:, None, :])
                & mask[:, :, None] & mask[:, None, :]).sum())
  f_w, s_w = PAIR_WORK['weight'][weight]
  f_l, s_l = PAIR_WORK['backward' if backward else 'forward'][loss]
  flops = float((n * n).sum()) + pref * (f_w + f_l)
  sfu = pref * (s_w + s_l)
  words_in = (4 if weight == 'dcg' else 2) * n.sum()
  words_out = (n.sum() if backward else 0) + len(n)
  return flops, sfu, F32 * float(words_in + words_out)


# -- the transformer encoder -------------------------------------------------


def encoder_forward_flops(tokens: np.ndarray, hidden: int, mlp: int,
                          layers: int) -> float:
  """Forward operations of a post-LN BERT encoder and its score head over
  documents of ``tokens[i]`` valid tokens each: per layer and token the
  four attention projections and the two MLP products, the attention's
  scores and weighted sum over the document's valid keys; then the pooler
  and the score a document."""
  t = np.asarray(tokens, np.float64)
  per_layer = (2 * t * (4 * hidden * hidden + 2 * hidden * mlp)
               + 4 * t * t * hidden)
  head = 2 * hidden * hidden + 2 * hidden
  return float((layers * per_layer + head).sum())


def encoder_train_flops(tokens: np.ndarray, hidden: int, mlp: int,
                        layers: int) -> float:
  """Forward and backward: each product once forward and twice backward
  (input and weight gradients; every input gradient is needed, down to the
  embeddings)."""
  return 3.0 * encoder_forward_flops(tokens, hidden, mlp, layers)
