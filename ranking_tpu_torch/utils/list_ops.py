"""Masking-aware list algebra on padded ``[batch, list_size]`` tensors.

The port's copy of the parts of ``ranking_tpu/utils/list_ops.py`` that the
eval and train paths use (the reference's tensorflow_ranking/python/utils.py). The
data model is the framework's: labels ``[B, L]`` padded with -1.0 (invalid
<=> label < 0), scores ``[B, L]``, example features ``[B, L, F]`` and an
optional boolean ``mask [B, L]``.

Sorting is deterministic by default: equal scores keep their position
(stable descending order) and invalid items go last. With a
``torch.Generator`` (the JAX package's ``key``), ``sort_by_scores`` and
``sorted_ranks`` break ties at random, as the training-time lambda weights
want: the call then takes the plain path, past the kernel and the shared
sort scope. The generator's numbers are not JAX's, so the two packages
agree on the deterministic calls and on the properties of the random ones.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ranking_tpu_torch.ops.cuda import sort as cuda_sort

Tensor = torch.Tensor

_SORT_SCOPE = threading.local()

# The reference's padding values of a densified ragged list
# (tensorflow_ranking/python/utils.py:421).
PADDING_LABEL = -1.0
PADDING_PREDICTION = -1e6
PADDING_WEIGHT = 0.0


@contextlib.contextmanager
def shared_sort_scope():
  """Share one full sort order across ``sort_by_scores`` calls.

  Inside this scope, every ``sort_by_scores(scores, ..., mask=mask)`` with
  the same (scores, mask, feature) tensor objects sorts the full list
  ONCE and serves each ``topn`` as a ``[:, :topn]`` slice. The order is a
  function of (scores, mask) only and full-sort-then-slice equals a direct
  stable top-k, so results are identical to the unscoped calls.

  The eval step wraps its metric loop in this scope: the default suite
  (NDCG@1/5/10/full + MRR) otherwise sorts the same scores five times.
  The cache is keyed by ``id()`` and holds references to its operands,
  which pins the ids for the life of the scope.
  """
  prev = getattr(_SORT_SCOPE, 'cache', None)
  _SORT_SCOPE.cache = {}
  try:
    yield
  finally:
    _SORT_SCOPE.cache = prev


def shared_sort_cache() -> Optional[dict]:
  """The active shared_sort_scope cache (None outside a scope). Other
  modules may intern derived tensors here (metric input preparation) so
  identical derivations share one tensor and thus one sort."""
  return getattr(_SORT_SCOPE, 'cache', None)


def is_label_valid(labels: Tensor) -> Tensor:
  """Boolean validity mask: an item is valid iff its label is >= 0."""
  return labels >= 0.0


def _shuffle_order(shape: Tuple[int, int], mask: Optional[Tensor],
                   generator: Optional[torch.Generator], device,
                   tie_draws: Optional[Tensor] = None) -> Tensor:
  """Per-row permutation that shuffles every list and pushes masked
  entries last: uniform keys in [0, 1) (the generator's, or
  ``tie_draws``), 2.0 added on masked entries, a stable argsort."""
  if tie_draws is not None:
    values = tie_draws.to(device=device, dtype=torch.float32)
  else:
    values = torch.rand(shape, generator=generator, dtype=torch.float32,
                        device=generator.device).to(device)
  if mask is not None:
    values = torch.where(mask.to(torch.bool), values, values + 2.0)
  return torch.argsort(values, dim=1, stable=True)


def _kernel_sort_ok(scores: Tensor, features_list: Sequence[Tensor]) -> bool:
  """Whether the CUDA sort kernel takes this call.

  The JAX package's dispatch rule (``_pallas_sort_ok``), for the card:
  scores on a CUDA device, a list size within the kernel's shared-memory
  domain, and 2-D floating channels. Channels travel as float32 through
  the kernel, exact for floats but not for integer ids above 2^24, so
  integer channels (e.g. ``sorted_ranks``' positions) take the plain path.
  On the CPU every call takes the plain path.
  """
  return (scores.device.type == 'cuda'
          and scores.shape[1] <= cuda_sort.MAX_LIST_SIZE
          and all(f.ndim == 2 and f.is_floating_point()
                  for f in features_list))


def sort_by_scores(
    scores: Tensor,
    features_list: Sequence[Tensor],
    topn: Optional[int] = None,
    mask: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
    tie_draws: Optional[Tensor] = None,
) -> List[Tensor]:
  """Sorts each feature tensor per list by descending ``scores``.

  Args:
    scores: ``[B, L]`` float scores.
    features_list: tensors of shape ``[B, L]`` or ``[B, L, ...]``.
    topn: cutoff; output lists have length ``min(topn, L)``.
    mask: optional ``[B, L]`` bool; invalid entries are pushed to the end.
    generator: optional source of random tie-breaking (training-time parity
      with the reference's ``shuffle_ties=True``). None = deterministic.
    tie_draws: optional ``[B, L]`` uniform [0, 1) draws that break ties as
      a generator's would (the kept draws of a loss called without one,
      ``sorting.fixed_draws``).

  Returns:
    List of tensors shaped ``[B, topn, ...]`` sorted by score.
  """
  scores = scores.to(torch.float32)
  list_size = scores.shape[1]
  topn = list_size if topn is None else min(topn, list_size)

  if generator is not None or tie_draws is not None:
    # The list is shuffled, the shuffled scores are sorted stably, and the
    # order is mapped back: ties land in the shuffle's order.
    if mask is not None:
      scores = torch.where(mask.to(torch.bool), scores, scores.min())
    shuffle = _shuffle_order(tuple(scores.shape), mask, generator,
                             scores.device, tie_draws)
    shuffled = torch.gather(scores, 1, shuffle)
    order = torch.sort(shuffled, dim=1, descending=True,
                       stable=True).indices[:, :topn]
    order = torch.gather(shuffle, 1, order)
    return [gather_per_row(f, order) for f in features_list]

  cache = getattr(_SORT_SCOPE, 'cache', None)
  if cache is not None:
    # Cache the FULL sorted channel per (scores, mask, feature) and serve
    # every topn as a slice; all missing channels ride one sort.
    misses = {}
    for f in features_list:
      fk = (id(scores), id(mask), id(f))
      if fk not in cache and fk not in misses:
        misses[fk] = f
    if misses:
      _SORT_SCOPE.cache = None  # the full sort itself runs uncached
      try:
        fulls = sort_by_scores(scores, list(misses.values()),
                               topn=list_size, mask=mask)
      finally:
        _SORT_SCOPE.cache = cache
      for (fk, f), full in zip(misses.items(), fulls):
        # Holding refs to the operands pins their ids for the scope.
        cache[fk] = (scores, mask, f, full)
    return [cache[(id(scores), id(mask), id(f))][3][:, :topn]
            for f in features_list]

  if _kernel_sort_ok(scores, features_list):
    out = cuda_sort.sort_by_scores(scores, features_list, topn=topn,
                                   mask=mask)
    return [o.to(f.dtype) for o, f in zip(out, features_list)]

  order = cuda_sort.sort_order(scores, mask)[:, :topn]
  return [gather_per_row(f, order) for f in features_list]


def sorted_ranks(scores: Tensor,
                 generator: Optional[torch.Generator] = None) -> Tensor:
  """1-based int32 rank of each item when its list is sorted by descending
  score; ties are broken by position, or at random with a ``generator``.
  ``[[1.0, 3.5, 2.1]]`` -> ``[[3, 1, 2]]``."""
  batch, list_size = scores.shape
  positions = torch.arange(list_size, device=scores.device).expand(
      batch, list_size)
  sorted_positions = sort_by_scores(scores, [positions],
                                    generator=generator)[0]
  return (torch.argsort(sorted_positions, dim=1, stable=True) + 1).to(
      torch.int32)


def organize_valid_indices(is_valid: Tensor,
                           draws: Optional[Tensor] = None) -> Tensor:
  """Per-row int64 indices placing valid items first.

  Deterministic (no ``draws``): each valid index goes to its compacted
  position (cumsum) and each invalid one after the valid run, O(B L), no
  sort. Shuffled: with ``[B, L]`` uniform [0, 1) ``draws`` (the JAX
  package's ``key`` draws them), a stable argsort of
  ``-where(valid, u, -1e-6)``, the JAX package's, so the valid items come
  first in a random order and the invalid ones after them in list order.
  """
  batch, list_size = is_valid.shape
  if draws is not None:
    rand = torch.where(is_valid, draws.to(is_valid.device, torch.float32),
                       -1e-6)
    return torch.argsort(-rand, dim=1, stable=True)
  valid = is_valid.to(torch.int64)
  positions = torch.cumsum(valid, dim=1) - 1
  num_valid = positions[:, -1:] + 1
  inv_positions = num_valid - 1 + torch.cumsum(1 - valid, dim=1)
  dest = torch.where(is_valid, positions, inv_positions)
  src = torch.arange(list_size, device=is_valid.device).expand(
      batch, list_size)
  return torch.zeros_like(dest).scatter_(1, dest, src)


def padded_gather_indices(is_valid: Tensor) -> Tuple[Tensor, Tensor]:
  """Circularly pads invalid slots with valid indices.

  Returns:
    (indices ``[B, L]`` int64, mask ``[B, L]`` bool). ``indices[b, k]``
    indexes into row ``b``; the first ``n_valid`` point at valid items in
    order, the rest wrap around circularly.
  """
  batch, list_size = is_valid.shape
  num_valid = torch.sum(is_valid.to(torch.int64), dim=1, keepdim=True)
  positions = torch.arange(list_size, device=is_valid.device).expand(
      batch, list_size)
  mask = positions < num_valid
  circular = torch.remainder(positions, torch.clamp(num_valid, min=1))
  valid_first = organize_valid_indices(is_valid)
  return torch.gather(valid_first, 1, circular), mask


def gather_per_row(inputs: Tensor, indices: Tensor) -> Tensor:
  """Per-row gather: ``out[b, k] = inputs[b, indices[b, k]]`` (2-D or 3-D+)."""
  indices = indices.to(torch.int64)
  extra = inputs.ndim - indices.ndim
  if extra:
    indices = indices.reshape(indices.shape + (1,) * extra).expand(
        indices.shape + inputs.shape[2:])
  return torch.gather(inputs, 1, indices)


def reshape_to_2d(tensor: Tensor) -> Tensor:
  """Converts a tensor to 2-D by squeezing trailing dims / expanding 1-D."""
  if tensor.ndim == 2:
    return tensor
  if tensor.ndim >= 3:
    return tensor.reshape(tensor.shape[:2])
  while tensor.ndim < 2:
    tensor = tensor[..., None]
  return tensor


def ragged_to_dense(
    list_of_labels: Sequence[Sequence[float]],
    list_of_predictions: Optional[Sequence[Sequence[float]]] = None,
    list_of_weights: Optional[Sequence[Sequence[float]]] = None,
    list_size: Optional[int] = None,
) -> Tuple[Tensor, Optional[Tensor], Optional[Tensor], Tensor]:
  """Densifies host-side variable-length lists to padded CPU tensors.

  Returns ``(labels, predictions, weights, mask)``, each ``[B, size]``;
  ``size`` is ``list_size`` or the longest list, and longer lists are cut.
  Padding is the reference's: label -1, prediction -1e6, weight 0.
  """
  lengths = [len(row) for row in list_of_labels]
  size = list_size or (max(lengths) if lengths else 0)

  def _pad(rows, fill):
    out = np.full((len(rows), size), fill, dtype=np.float32)
    for i, row in enumerate(rows):
      n = min(len(row), size)
      out[i, :n] = np.asarray(row, dtype=np.float32)[:n]
    return torch.from_numpy(out)

  labels = _pad(list_of_labels, PADDING_LABEL)
  predictions = (_pad(list_of_predictions, PADDING_PREDICTION)
                 if list_of_predictions is not None else None)
  weights = (_pad(list_of_weights, PADDING_WEIGHT)
             if list_of_weights is not None else None)
  mask = torch.from_numpy(
      np.arange(size)[None, :] < np.asarray(lengths)[:, None])
  return labels, predictions, weights, mask


def de_noise(counts: Tensor, noise: Tensor, ratio: float = 0.9) -> Tensor:
  """Exact MLE de-noising of a count distribution against a noise mixture
  (tensorflow_ranking/python/utils.py:359).

  Solves for the true distribution assuming
  ``observed ~ ratio * noise + (1 - ratio) * true`` per row, by the sorted
  simplex projection of Zhang & Xu, "Fast Exact Maximum Likelihood
  Estimation for Mixture of Language Models". float32, ``[B, N]``.
  """
  if not 0.0 < ratio < 1.0:
    raise ValueError(f'ratio must be in (0, 1), got {ratio}')
  odds = (1.0 - ratio) / ratio
  counts = counts.to(torch.float32)
  noise = noise.to(torch.float32)
  noise = noise / torch.sum(noise, dim=1, keepdim=True)

  order = torch.argsort(-(counts / noise), dim=1, stable=True)
  sorted_counts = torch.gather(counts, 1, order)
  sorted_noise = torch.gather(noise, 1, order)
  is_pos = ((odds + torch.cumsum(sorted_noise, dim=1))
            / torch.cumsum(sorted_counts, dim=1)
            > sorted_noise / sorted_counts).to(torch.float32)
  lagrangian = (
      torch.sum(sorted_counts * is_pos, dim=1, keepdim=True)
      / (1.0 + torch.sum(sorted_noise * is_pos, dim=1, keepdim=True) / odds))
  res = (sorted_counts / lagrangian - sorted_noise / odds) * is_pos
  inverse = torch.argsort(order, dim=1, stable=True)
  return torch.gather(res, 1, inverse)


def parse_keys_and_weights(key: str) -> Dict[str, float]:
  """Parses ``'softmax_loss:0.9,sigmoid_cross_entropy_loss:0.1'`` to a dict."""

  def _parse(kw: str) -> Tuple[str, float]:
    if ':' in kw:
      name, weight = kw.split(':')
      return name, float(weight)
    return kw, 1.0

  key = key.replace(' ', '')
  return dict(_parse(part) for part in key.split(','))
