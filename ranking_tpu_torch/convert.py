"""Carries a JAX package model's variables over to the port.

``from_flax`` maps the ``{'params', 'batch_stats'}`` tree of
``ranking_tpu.models.RankingModel(DNNScorer(...))``, given as numpy
arrays, to the ``state_dict`` of the port's
``RankingModel(DNNScorer(...))``:

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
compare the two packages leaf by leaf.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Any, Dict, Mapping

import numpy as np
import torch

_PREFIX = 'scorer.tower.'


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
  try:
    tower = variables['params']['scorer']['Tower_0']
  except KeyError as e:
    raise ValueError('expected the variables of RankingModel(DNNScorer(...)): '
                     "params/scorer/Tower_0 is missing") from e
  stats = variables.get('batch_stats', {}).get('scorer', {}).get('Tower_0', {})
  dense = _indexed(tower, 'Dense')
  bns = _indexed(tower, 'BatchNorm')
  if list(dense) != list(range(len(dense))) or not dense:
    raise ValueError(f'Dense layers are not numbered 0..n: {sorted(dense)}')
  state = OrderedDict()
  for i, layer in dense.items():
    state[f'{_PREFIX}dense.{i}.weight'] = _tensor(layer['kernel']).T.contiguous()
    state[f'{_PREFIX}dense.{i}.bias'] = _tensor(layer['bias'])
  names = [f'bn.{i}' for i in range(len(bns) - int(input_batch_norm))]
  if input_batch_norm:
    names.insert(0, 'input_bn')
  if len(names) != len(bns):
    raise ValueError('input_batch_norm=True but the tower has no BatchNorm')
  for name, (i, bn) in zip(names, bns.items()):
    stat = stats.get(f'BatchNorm_{i}')
    if stat is None:
      raise ValueError(f'batch_stats of BatchNorm_{i} are missing')
    state[f'{_PREFIX}{name}.weight'] = _tensor(bn['scale'])
    state[f'{_PREFIX}{name}.bias'] = _tensor(bn['bias'])
    state[f'{_PREFIX}{name}.running_mean'] = _tensor(stat['mean'])
    state[f'{_PREFIX}{name}.running_var'] = _tensor(stat['var'])
    state[f'{_PREFIX}{name}.num_batches_tracked'] = torch.tensor(0)
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
  leaves = {'weight': ('params', 'scale'), 'bias': ('params', 'bias'),
            'running_mean': ('batch_stats', 'mean'),
            'running_var': ('batch_stats', 'var')}
  for name, tensor in named.items():
    if not name.startswith(_PREFIX):
      raise ValueError(f'{name!r} is not a parameter of the DNN tower')
    if tensor is None or name.endswith('num_batches_tracked'):
      continue
    value = tensor.detach().to('cpu', torch.float32).numpy()
    parts = name[len(_PREFIX):].split('.')
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
  tree: Dict[str, Any] = {'params': {'scorer': {'Tower_0': params}}}
  if stats:
    tree['batch_stats'] = {'scorer': {'Tower_0': stats}}
  return tree
