"""Carries a JAX package model's variables over to the port.

``from_flax`` maps the ``{'params', 'batch_stats'}`` tree of a
``ranking_tpu.models.RankingModel`` over a ``DNNScorer``, a
``GroupwiseDNNScorer``, a ``GAMScorer``, a ``DINScorer``, an
``EmbeddingDNNScorer`` or a ``MultiTaskScorer``, given as numpy arrays, to
the ``state_dict`` of the port's model of the same kind. The DNN tower lies
at one of these flax paths under ``params`` (and ``batch_stats``):

* ``scorer/Tower_0`` -> ``scorer.tower.`` (``DNNScorer``);
* ``scorer/dnn/Tower_0`` -> ``scorer.dnn.tower.`` (``EmbeddingDNNScorer``,
  whose tables ``scorer/embed_<f>/embedding`` are
  ``scorer.embed_<f>.embedding``);
* ``scorer/DNNScorer_0/Tower_0`` -> ``scorer.shared.tower.``
  (``MultiTaskScorer`` with the body built inside);
* ``scorer/body/Tower_0`` -> ``scorer.body.tower.`` and
  ``scorer/body/dnn/Tower_0`` -> ``scorer.body.dnn.tower.``
  (``MultiTaskScorer`` over a given ``DNNScorer`` or ``EmbeddingDNNScorer``
  body, whose tables are ``scorer.body.embed_<f>.embedding``).

In the tower:

* ``Dense_i/kernel`` ``[in, out]`` -> ``dense.i.weight`` ``[out, in]``,
  ``Dense_i/bias`` -> ``dense.i.bias``; the output layer is
  ``Dense_{len(hidden)}``;
* ``BatchNorm_i/{scale, bias}`` -> ``bn.i.{weight, bias}``;
* ``batch_stats .../BatchNorm_i/{mean, var}`` ->
  ``bn.i.{running_mean, running_var}``.

With ``input_batch_norm=True`` the tower's first BatchNorm (flax
``BatchNorm_0``) is the input one and the hidden ones follow it.

The other scorers and layers:

* ``GroupwiseDNNScorer``: its tower (``output_units = g``) is
  ``scorer/Tower_0`` -> ``scorer.tower.``, as a ``DNNScorer``'s;
* ``GAMScorer``: ``scorer/GAMLayer_0/example_tower_i`` and
  ``.../context_tower_i`` -> ``scorer.gam.example_tower_i.`` and
  ``scorer.gam.context_tower_i.``, towers as above;
* ``DINScorer``: its tower is ``scorer/Tower_0``, and
  ``scorer/DocumentInteractionAttention_0`` -> ``scorer.attention.``:
  ``Dense_0/kernel`` ``[F, head_size]`` -> ``dense.weight`` (transposed, no
  bias), ``LayerNorm_i/{scale, bias}`` -> ``norms.i.{weight, bias}``, and
  ``MultiHeadDotProductAttention_i/{query, key, value, out}/{kernel, bias}``
  -> ``attentions.i.{query, key, value, out}.{kernel, bias}`` in flax's
  layout (``[F, heads, head_dim]``, ``[heads, head_dim, F]``);
* a ``Bilinear`` layer's own variables: ``bilinear_kernel`` ``[Dx, O, Dy]``
  and ``bias`` keep their names and layout;
* ``EncoderScorer`` (``scorer/encoder/...`` and ``scorer/score``) and a bare
  ``TransformerEncoder`` (``token_embed``, ``pos_embed``, ``type_embed``,
  ``LayerNorm_0``, ``block_i/{MultiHeadDotProductAttention_0/{query, key,
  value, out}, LayerNorm_0, Dense_0, Dense_1, LayerNorm_1}``, ``pooler``):
  the port's encoder keeps flax's names and layouts, so each path maps to
  the name with '.' for '/', the leaf as it is.

The example programs' own modules hold one of these scorers a level down;
its flax tree is read as a ``RankingModel``'s ``scorer`` and its names
move under the module's prefix (``_NESTED``), and the embedding tables
beside it (flax ``<path>/embedding``) keep their paths, '.' for '/':

* ``examples/ranking_libsvm.py``'s ``SplitGAM``:
  ``scorer/GAMScorer_0/GAMLayer_0/example_tower_i`` ->
  ``scorer.gam_scorer.gam.example_tower_i.`` (a tower a LIBSVM column,
  ``col_000``... in order);
* ``examples/antique_din.py``'s ``Scorer``: ``scorer/DINScorer_0/...`` ->
  ``scorer.din.`` + the ``DINScorer``'s names, and the tables
  ``scorer/embed_q/embedding``, ``scorer/embed_d/embedding``;
* ``examples/unbiased_two_tower.py``'s ``TwoTower`` (the model itself, no
  ``RankingModel``): ``relevance/Tower_0`` -> ``relevance.tower.`` and
  ``position_bias/embedding`` -> ``position_bias.embedding``.

``examples/encoder_ranking.py``'s model is a ``RankingModel`` over an
``EncoderScorer``, above.

``from_flax_sharded`` gives one rank's shards of the same, for a model
laid out over a ``parallel`` mesh.

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

# (flax path of the tower under the model's variables, the port's prefix
# of its parameters); the tables of an embedding scorer lie beside its
# 'dnn' at the same level.
_TOWERS = (
    (('scorer', 'Tower_0'), 'scorer.tower.'),
    (('scorer', 'dnn', 'Tower_0'), 'scorer.dnn.tower.'),
    (('scorer', 'DNNScorer_0', 'Tower_0'), 'scorer.shared.tower.'),
    (('scorer', 'body', 'Tower_0'), 'scorer.body.tower.'),
    (('scorer', 'body', 'dnn', 'Tower_0'), 'scorer.body.dnn.tower.'),
)
_TABLE = re.compile(r'(scorer(?:\.body)?)\.(embed_[^.]+)\.embedding')
_GAM = ('scorer', 'GAMLayer_0')
_GAM_TOWER = re.compile(r'scorer\.gam\.((?:example|context)_tower_\d+)\.')
_ATTENTION = ('scorer', 'DocumentInteractionAttention_0')
_ATTENTION_PREFIX = 'scorer.attention.'
_MHA_PARTS = ('query', 'key', 'value', 'out')
_BILINEAR = ('bilinear_kernel', 'bias')
# (flax path of a scorer held a level down, the port's prefix of its
# parameters): the example programs' SplitGAM, DIN scorer and TwoTower.
_NESTED = (
    (('scorer', 'GAMScorer_0'), 'scorer.gam_scorer.'),
    (('scorer', 'DINScorer_0'), 'scorer.din.'),
    (('relevance',), 'relevance.'),
)
# A table beside a nested scorer: '<path>.embedding'.
_SIDE_TABLE = re.compile(r'[A-Za-z0-9_]+(\.[A-Za-z0-9_]+)*\.embedding')
# The encoder family's flax paths, which are the port's names.
_ENCODER = re.compile(
    r'(scorer\.(encoder|score)\.|(token_embed|pos_embed|type_embed'
    r'|LayerNorm_0|block_\d+|pooler)\.)')


def _at(tree: Mapping[str, Any], path) -> Any:
  for name in path:
    if not isinstance(tree, Mapping) or name not in tree:
      return None
    tree = tree[name]
  return tree


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
  """The port's ``state_dict`` for a flax ranking model's variables (or a
  ``Bilinear`` layer's)."""
  params = variables.get('params', {})
  stats = variables.get('batch_stats', {})
  if set(params) == set(_BILINEAR):
    return OrderedDict((name, _tensor(params[name])) for name in _BILINEAR)
  for path, prefix in _NESTED:
    inner = _at(params, path)
    if inner is not None:
      return _from_nested(params, stats, path, prefix, input_batch_norm)
  if 'token_embed' in params or _at(params, ('scorer', 'encoder')) is not None:
    return OrderedDict((name, _tensor(leaf))
                       for name, leaf in _dotted_leaves(params))
  gam = _at(params, _GAM)
  if gam is not None:
    towers = [(_GAM + (name,), f'scorer.gam.{name}.') for name in sorted(gam)
              if re.fullmatch(r'(example|context)_tower_\d+', name)]
  else:
    towers = [(path, prefix) for path, prefix in _TOWERS
              if _at(params, path) is not None]
    if len(towers) != 1:
      raise ValueError(
          'expected the variables of RankingModel over a DNNScorer, a '
          'GroupwiseDNNScorer, a DINScorer, an EmbeddingDNNScorer or a '
          'MultiTaskScorer: exactly one of '
          + ', '.join('params/' + '/'.join(p) for p, _ in _TOWERS)
          + ', or a GAMScorer (params/' + '/'.join(_GAM) + '); found '
          f'{["/".join(p) for p, _ in towers]}')
  state = OrderedDict()
  path = towers[0][0]
  owner = path[:-2] if path[-2] == 'dnn' else None
  if owner is not None:
    for name, leaf in _at(params, owner).items():
      if name.startswith('embed_'):
        state['.'.join(owner + (name, 'embedding'))] = _tensor(
            leaf['embedding'])
  for path, prefix in towers:
    state.update(_tower_state(_at(params, path), _at(stats, path) or {},
                              prefix, input_batch_norm))
  attention = _at(params, _ATTENTION)
  if attention is not None:
    state[f'{_ATTENTION_PREFIX}dense.weight'] = _tensor(
        attention['Dense_0']['kernel']).T.contiguous()
    for i, norm in _indexed(attention, 'LayerNorm').items():
      state[f'{_ATTENTION_PREFIX}norms.{i}.weight'] = _tensor(norm['scale'])
      state[f'{_ATTENTION_PREFIX}norms.{i}.bias'] = _tensor(norm['bias'])
    for i, mha in _indexed(attention, 'MultiHeadDotProductAttention').items():
      for part in _MHA_PARTS:
        for leaf in ('kernel', 'bias'):
          state[f'{_ATTENTION_PREFIX}attentions.{i}.{part}.{leaf}'] = \
              _tensor(mha[part][leaf])
  return state


def _from_nested(params, stats, path, prefix: str, input_batch_norm: bool
                 ) -> 'OrderedDict[str, torch.Tensor]':
  """``from_flax`` of a model holding its scorer at ``path``: that
  scorer's tree read as a ``RankingModel``'s, its names under ``prefix``,
  and the embedding tables beside it."""
  inner = from_flax({'params': {'scorer': _at(params, path)},
                     'batch_stats': {'scorer': _at(stats, path) or {}}},
                    input_batch_norm=input_batch_norm)
  state = OrderedDict((prefix + name[len('scorer.'):], leaf)
                      for name, leaf in inner.items())
  nested = '.'.join(path) + '.'
  for name, leaf in _dotted_leaves(params):
    if name.startswith(nested):
      continue
    if not _SIDE_TABLE.fullmatch(name):
      raise ValueError(f'{name!r} beside the scorer at {"/".join(path)} is '
                       'not an embedding table')
    state[name] = _tensor(leaf)
  return state


def from_flax_sharded(variables: Mapping[str, Any], model: torch.nn.Module,
                      mesh, input_batch_norm: bool = False
                      ) -> 'OrderedDict[str, torch.Tensor]':
  """One rank's ``state_dict`` for a flax model's whole variables (numpy
  arrays): ``from_flax``, then the rank's slice of each parameter that
  ``model`` holds split over ``mesh``'s model group
  (``parallel.mesh.shard_module``, ``ShardedEmbeddingEncoder``)."""
  from ranking_tpu_torch.parallel import mesh as mesh_lib
  whole = from_flax(variables, input_batch_norm=input_batch_norm)
  return OrderedDict(mesh_lib.shard_state_dict(whole, model, mesh))


def _dotted_leaves(tree: Mapping[str, Any], prefix: str = ''):
  for name in sorted(tree):
    if isinstance(tree[name], Mapping):
      yield from _dotted_leaves(tree[name], f'{prefix}{name}.')
    else:
      yield f'{prefix}{name}', tree[name]


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


def _put(tree: Dict[str, Any], path, value) -> None:
  for name in path[:-1]:
    tree = tree.setdefault(name, {})
  tree[path[-1]] = value


def to_flax(named: Mapping[str, torch.Tensor],
            input_batch_norm: bool = False) -> Dict[str, Any]:
  """The flax ``{'params', 'batch_stats'}`` tree (numpy leaves) of tensors
  keyed by the port's ``state_dict`` names.

  Keys that are missing (a gradient dictionary has no running statistics)
  are left out of the tree; ``num_batches_tracked`` has no flax
  counterpart.
  """
  for path, prefix in _NESTED:
    inner = {'scorer.' + name[len(prefix):]: tensor
             for name, tensor in named.items() if name.startswith(prefix)}
    if inner:
      tree: Dict[str, Any] = {}
      for name, tensor in named.items():
        if name.startswith(prefix):
          continue
        if not _SIDE_TABLE.fullmatch(name):
          raise ValueError(f'{name!r} beside the scorer at '
                           f'{"/".join(path)} is not an embedding table')
        _put(tree, ('params',) + tuple(name.split('.')),
             tensor.detach().to('cpu', torch.float32).numpy())
      for collection, node in to_flax(inner, input_batch_norm).items():
        _put(tree, (collection,) + path, node['scorer'])
      return tree
  tree: Dict[str, Any] = {}
  leaves = {'weight': ('params', 'scale'), 'bias': ('params', 'bias'),
            'running_mean': ('batch_stats', 'mean'),
            'running_var': ('batch_stats', 'var')}
  # Longest prefix first: 'scorer.body.dnn.tower.' before 'scorer.tower.'.
  towers = sorted(_TOWERS, key=lambda t: -len(t[1]))
  paths = set()
  for name, tensor in named.items():
    if tensor is None or name.endswith('num_batches_tracked'):
      continue
    value = tensor.detach().to('cpu', torch.float32).numpy()
    table = _TABLE.fullmatch(name)
    if table:
      _put(tree, ('params',) + tuple(table.group(1).split('.'))
           + (table.group(2), 'embedding'), value)
      continue
    if name in _BILINEAR:
      _put(tree, ('params', name), value)
      continue
    if _ENCODER.match(name):
      _put(tree, ('params',) + tuple(name.split('.')), value)
      continue
    if name.startswith(_ATTENTION_PREFIX):
      _put(tree, ('params',) + _ATTENTION + _attention_path(
          name[len(_ATTENTION_PREFIX):]),
           value.T.copy() if name.endswith('dense.weight') else value)
      continue
    gam = _GAM_TOWER.match(name)
    if gam:
      path, prefix = _GAM + (gam.group(1),), gam.group(0)
      family = _GAM
    else:
      path, prefix = next(((p, q) for p, q in towers if name.startswith(q)),
                          (None, None))
      family = path
    if path is None:
      raise ValueError(f'{name!r} is not a parameter of a ported model')
    paths.add(family)
    parts = name[len(prefix):].split('.')
    if parts[0] == 'dense':
      leaf = 'kernel' if parts[2] == 'weight' else 'bias'
      _put(tree, ('params',) + path + (f'Dense_{parts[1]}', leaf),
           value.T.copy() if parts[2] == 'weight' else value)
      continue
    if parts[0] == 'input_bn':
      index, leaf = 0, parts[1]
    elif parts[0] == 'bn':
      index, leaf = int(parts[1]) + int(input_batch_norm), parts[2]
    else:
      raise ValueError(f'{name!r} is not a parameter of a DNN tower')
    collection, flax_leaf = leaves[leaf]
    _put(tree, (collection,) + path + (f'BatchNorm_{index}', flax_leaf),
         value)
  if len(paths) > 1:
    raise ValueError('parameters of more than one tower layout are mixed: '
                     + ', '.join(sorted('/'.join(p) for p in paths)))
  return tree


def _attention_path(rest: str) -> tuple:
  """The flax path, under ``DocumentInteractionAttention_0``, of the
  attention's parameter ``rest`` (its port name after the prefix)."""
  parts = rest.split('.')
  if parts == ['dense', 'weight']:
    return ('Dense_0', 'kernel')
  if parts[0] == 'norms':
    return (f'LayerNorm_{parts[1]}',
            'scale' if parts[2] == 'weight' else 'bias')
  if parts[0] == 'attentions' and parts[2] in _MHA_PARTS:
    return (f'MultiHeadDotProductAttention_{parts[1]}', parts[2], parts[3])
  raise ValueError(f'{rest!r} is not a parameter of the DIN attention')


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
