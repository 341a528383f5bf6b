"""Carries a JAX package model's variables over to the port.

``from_flax`` maps the ``{'params', 'batch_stats'}`` tree of
``ranking_tpu.models.RankingModel(DNNScorer(...))`` or
``RankingModel(EmbeddingDNNScorer(...))``, given as numpy arrays, to the
``state_dict`` of the port's model of the same kind. The tower lies at
``scorer/Tower_0`` (``scorer.tower.``), or at ``scorer/dnn/Tower_0``
(``scorer.dnn.tower.``) under an ``EmbeddingDNNScorer``, whose tables
``scorer/embed_<f>/embedding`` are ``scorer.embed_<f>.embedding``. In the
tower:

* ``Dense_i/kernel`` ``[in, out]`` -> ``dense.i.weight`` ``[out, in]``,
  ``Dense_i/bias`` -> ``dense.i.bias``; the output layer is
  ``Dense_{len(hidden)}``;
* ``BatchNorm_i/{scale, bias}`` -> ``bn.i.{weight, bias}``;
* ``batch_stats .../BatchNorm_i/{mean, var}`` ->
  ``bn.i.{running_mean, running_var}``.

With ``input_batch_norm=True`` the tower's first BatchNorm (flax
``BatchNorm_0``) is the input one and the hidden ones follow it.

``to_flax`` is the inverse, for anything keyed like the port's
``state_dict``: parameters after a train step, or gradients
(``{name: p.grad}``). It lays them out as the flax tree, so that tests
compare the two packages leaf by leaf; ``sparse_state_to_flax`` does the
same for the state of a lazy-row optimizer (``train/sparse.py``).
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Any, Dict, Mapping

import numpy as np
import torch

_PREFIX = 'scorer.tower.'
_EMBEDDING_PREFIX = 'scorer.dnn.tower.'


def _indexed(tree: Mapping[str, Any], kind: str) -> Dict[int, Any]:
  out = {}
  for name, leaf in tree.items():
    m = re.fullmatch(f'{kind}_(\\d+)', name)
    if m:
      out[int(m.group(1))] = leaf
  return dict(sorted(out.items()))


def _tensor(x) -> torch.Tensor:
  return torch.from_numpy(np.array(x, dtype=np.float32))


def from_flax(variables: Mapping[str, Any],
              input_batch_norm: bool = False) -> 'OrderedDict[str, torch.Tensor]':
  """The port's ``state_dict`` for a flax DNN ranking model's variables."""
  scorer = variables.get('params', {}).get('scorer', {})
  stats = variables.get('batch_stats', {}).get('scorer', {})
  prefix = _PREFIX
  state = OrderedDict()
  if 'dnn' in scorer:
    scorer, stats, prefix = scorer['dnn'], stats.get('dnn', {}), \
        _EMBEDDING_PREFIX
    for name, leaf in variables['params']['scorer'].items():
      if name.startswith('embed_'):
        state[f'scorer.{name}.embedding'] = _tensor(leaf['embedding'])
  if 'Tower_0' not in scorer:
    raise ValueError('expected the variables of RankingModel(DNNScorer(...)) '
                     'or RankingModel(EmbeddingDNNScorer(...)): '
                     'params/scorer/Tower_0 or params/scorer/dnn/Tower_0 is '
                     'missing')
  state.update(_tower_state(scorer['Tower_0'], stats.get('Tower_0', {}),
                            prefix, input_batch_norm))
  return state


def _tower_state(tower, stats, prefix: str,
                 input_batch_norm: bool) -> 'OrderedDict[str, torch.Tensor]':
  dense = _indexed(tower, 'Dense')
  bns = _indexed(tower, 'BatchNorm')
  if list(dense) != list(range(len(dense))) or not dense:
    raise ValueError(f'Dense layers are not numbered 0..n: {sorted(dense)}')
  state = OrderedDict()
  for i, layer in dense.items():
    state[f'{prefix}dense.{i}.weight'] = _tensor(layer['kernel']).T.contiguous()
    state[f'{prefix}dense.{i}.bias'] = _tensor(layer['bias'])
  names = [f'bn.{i}' for i in range(len(bns) - int(input_batch_norm))]
  if input_batch_norm:
    names.insert(0, 'input_bn')
  if len(names) != len(bns):
    raise ValueError('input_batch_norm=True but the tower has no BatchNorm')
  for name, (i, bn) in zip(names, bns.items()):
    stat = stats.get(f'BatchNorm_{i}')
    if stat is None:
      raise ValueError(f'batch_stats of BatchNorm_{i} are missing')
    state[f'{prefix}{name}.weight'] = _tensor(bn['scale'])
    state[f'{prefix}{name}.bias'] = _tensor(bn['bias'])
    state[f'{prefix}{name}.running_mean'] = _tensor(stat['mean'])
    state[f'{prefix}{name}.running_var'] = _tensor(stat['var'])
    state[f'{prefix}{name}.num_batches_tracked'] = torch.tensor(0)
  return state


def to_flax(named: Mapping[str, torch.Tensor],
            input_batch_norm: bool = False) -> Dict[str, Any]:
  """The flax ``{'params', 'batch_stats'}`` tree (numpy leaves) of tensors
  keyed by the port's ``state_dict`` names.

  Keys that are missing (a gradient dictionary has no running statistics)
  are left out of the tree; ``num_batches_tracked`` has no flax
  counterpart.
  """
  params: Dict[str, Dict[str, np.ndarray]] = {}
  stats: Dict[str, Dict[str, np.ndarray]] = {}
  tables: Dict[str, Dict[str, np.ndarray]] = {}
  leaves = {'weight': ('params', 'scale'), 'bias': ('params', 'bias'),
            'running_mean': ('batch_stats', 'mean'),
            'running_var': ('batch_stats', 'var')}
  prefixes = set()
  for name, tensor in named.items():
    if tensor is None or name.endswith('num_batches_tracked'):
      continue
    value = tensor.detach().to('cpu', torch.float32).numpy()
    table = re.fullmatch(r'scorer\.(embed_[^.]+)\.embedding', name)
    if table:
      tables[table.group(1)] = {'embedding': value}
      continue
    prefix = next((p for p in (_PREFIX, _EMBEDDING_PREFIX)
                   if name.startswith(p)), None)
    if prefix is None:
      raise ValueError(f'{name!r} is not a parameter of the DNN tower')
    prefixes.add(prefix)
    parts = name[len(prefix):].split('.')
    if parts[0] == 'dense':
      layer = params.setdefault(f'Dense_{parts[1]}', {})
      layer['kernel' if parts[2] == 'weight' else 'bias'] = (
          value.T.copy() if parts[2] == 'weight' else value)
      continue
    if parts[0] == 'input_bn':
      index, leaf = 0, parts[1]
    elif parts[0] == 'bn':
      index, leaf = int(parts[1]) + int(input_batch_norm), parts[2]
    else:
      raise ValueError(f'{name!r} is not a parameter of the DNN tower')
    collection, flax_leaf = leaves[leaf]
    target = params if collection == 'params' else stats
    target.setdefault(f'BatchNorm_{index}', {})[flax_leaf] = value
  if len(prefixes) > 1:
    raise ValueError('parameters of a DNNScorer and of an EmbeddingDNNScorer '
                     'tower are mixed')
  nested = bool(tables) or prefixes == {_EMBEDDING_PREFIX}
  wrap = (lambda t: {'dnn': {'Tower_0': t}}) if nested else (  # noqa: E731
      lambda t: {'Tower_0': t})
  tree: Dict[str, Any] = {'params': {'scorer': {**wrap(params), **tables}}}
  if stats:
    tree['batch_stats'] = {'scorer': wrap(stats)}
  return tree


def sparse_state_to_flax(sparse_opt_state: Mapping[str, Any]) -> Dict[str, Any]:
  """A lazy-row optimizer's state (``TrainState.sparse_opt_state``) laid
  out as the JAX package's: ``{path: {'m', 'v'} or {'acc'}, 'count',
  'dropped'}`` with numpy leaves (float32 moments, int32 counters)."""
  out: Dict[str, Any] = {}
  for key, value in sparse_opt_state.items():
    if isinstance(value, Mapping):
      out[key] = {k: v.detach().to('cpu', torch.float32).numpy()
                  for k, v in value.items()}
    else:
      out[key] = value.detach().to('cpu', torch.int32).numpy()
  return out
