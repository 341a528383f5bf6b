"""Self-contained serving artifacts: exported programs + manifest + params.

The port's copy of ``ranking_tpu/pipeline/export.py``, the
deploy-without-code analog of the reference's SavedModel ``Signatures``
export (tensorflow_ranking/python/keras/saved_model.py:24-175):
``export_predictor`` writes the model's eval forward as a ``torch.export``
program (the batch dimension symbolic) at one or more list-size buckets,
beside a JSON manifest of the feature specs and an ``.npz`` of the
weights. ``load_predictor`` rebuilds a working predictor from the artifact
alone: no model class, no import of ``ranking_tpu_torch.models``, no
Python code from training time.

Artifact layout::

    <path>/manifest.json          feature specs, buckets, quantization
    <path>/params.npz             the weights, their only copy
    <path>/apply_L<bucket>.pt2    torch.export.save of the program a bucket

The weights are inputs of the exported program (``torch.func.
functional_call`` over a dict of tensors), never constants in it: an
export that would hold a tensor raises. ``params.npz`` holds the model's
``state_dict`` as a tree split at its dots; with ``quantize='int8'`` its
large float matrices are int8 values and float scales, dequantized inside
the program. Scales are per output channel of a Dense kernel and per row
of an embedding table, as the JAX package picks them on its flax layout:
the rule is applied to the flax view of an ``nn.Linear`` weight (its
transpose) and the values are stored back in torch's layout.

The program holds aten operations only (the eval forward runs no hand
kernel) and no device: the trace's device checks are taken out, so an
artifact exported on the CPU serves on ``cuda``. A node that still names a
device is recorded in the manifest, and loading on another device raises.

The loaded predictor has the surface of ``pipeline.serving.Predictor``
(``predict``, ``regress``, ``score_batch``) and keeps the predict ==
regress parity (python/keras/pipeline_test.py:238).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ranking_tpu_torch.data import parsers
from ranking_tpu_torch.utils.device import DeviceLike, resolve_device

_MANIFEST = 'manifest.json'
_PARAMS = 'params.npz'
_SEP = '|'  # flattened-tree key separator (never in a variable name)


# ---------------------------------------------------------------------------
# Feature-spec (de)serialization
# ---------------------------------------------------------------------------


def spec_to_json(spec: parsers.FeatureSpec) -> dict:
  if isinstance(spec, parsers.FixedLenFeature):
    return {'kind': 'fixed', 'shape': list(spec.shape), 'dtype': spec.dtype,
            'default_value': spec.default_value}
  if isinstance(spec, parsers.VarLenFeature):
    vocab = None
    if spec.vocab is not None:
      inv = sorted(spec.vocab._map.items(), key=lambda kv: kv[1])
      # surrogateescape round-trips arbitrary (non-UTF-8) token bytes
      # through JSON; spec_from_json re-encodes with the same handler.
      vocab = {'tokens': [t.decode('utf-8', 'surrogateescape')
                          for t, _ in inv],
               'num_oov_buckets': spec.vocab.num_oov_buckets}
    return {'kind': 'varlen', 'dtype': spec.dtype, 'max_len': spec.max_len,
            'pad_value': spec.pad_value, 'hash_buckets': spec.hash_buckets,
            'vocab': vocab}
  raise TypeError(f'Unknown spec type: {type(spec)}')


def spec_from_json(d: Mapping[str, Any]) -> parsers.FeatureSpec:
  if d['kind'] == 'fixed':
    return parsers.FixedLenFeature(shape=tuple(d['shape']), dtype=d['dtype'],
                                   default_value=d['default_value'])
  vocab = None
  if d.get('vocab'):
    vocab = parsers.Vocabulary(
        [t.encode('utf-8', 'surrogateescape') for t in d['vocab']['tokens']],
        num_oov_buckets=d['vocab']['num_oov_buckets'])
  return parsers.VarLenFeature(dtype=d['dtype'], max_len=d['max_len'],
                               pad_value=d['pad_value'], vocab=vocab,
                               hash_buckets=d['hash_buckets'])


# ---------------------------------------------------------------------------
# Variables <-> npz
# ---------------------------------------------------------------------------


def _nest(state_dict: Mapping[str, Any]) -> dict:
  """A ``state_dict``'s flat dotted names as a tree of dicts; a tree is
  returned as it is."""
  tree: dict = {}
  for name, leaf in state_dict.items():
    if not isinstance(name, str) or '.' not in name:
      tree[name] = leaf
      continue
    node = tree
    parts = name.split('.')
    for part in parts[:-1]:
      node = node.setdefault(part, {})
    node[parts[-1]] = leaf
  return tree


def _dotted(tree: Mapping[str, Any], prefix: str = '') -> Dict[str, Any]:
  """The inverse of ``_nest``: ``{dotted name: leaf}``."""
  out = {}
  for k, v in tree.items():
    if isinstance(v, Mapping):
      out.update(_dotted(v, f'{prefix}{k}.'))
    else:
      out[f'{prefix}{k}'] = v
  return out


def _sorted_tree(tree):
  """Dicts with sorted keys, all the way down: the exported program's
  inputs are matched by their tree structure, key order included."""
  if isinstance(tree, Mapping):
    return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
  return tree


def _as_plain_dicts(tree, where='variables'):
  """Validates the variables tree as nested str-keyed dicts, the only
  structure ``_unflatten_vars`` can rebuild at load time: anything else
  must fail at export, not at the first serving call."""
  if isinstance(tree, Mapping):
    out = {}
    for k, v in tree.items():
      if not isinstance(k, str):
        raise TypeError(
            f'export_predictor requires str-keyed dict variables; got key '
            f'{k!r} at {where}')
      if _SEP in k:
        raise TypeError(f'variable key {k!r} contains the reserved '
                        f'separator {_SEP!r} (at {where})')
      out[k] = _as_plain_dicts(v, f'{where}/{k}')
    return out
  if isinstance(tree, (list, tuple)):
    raise TypeError(
        f'export_predictor requires nested dict variables; got '
        f'{type(tree).__name__} at {where}: restructure or wrap the '
        'sequence in a dict with string keys')
  return tree


# numpy has no bfloat16. Such leaves are stored as a uint16 view under a
# tagged companion key (the JAX package's format) and viewed back on load
# through torch, so that no ml_dtypes is needed.
_DTYPE_TAG = '::dtype'
_BF16 = 'bfloat16'


def _leaf_array(leaf):
  """(numpy array, dtype tag or None) of a tensor or numpy leaf."""
  if torch.is_tensor(leaf):
    leaf = leaf.detach().cpu()
    if leaf.dtype == torch.bfloat16:
      return leaf.view(torch.int16).numpy().view(np.uint16), _BF16
    return leaf.numpy(), None
  arr = np.asarray(leaf)
  if arr.dtype.kind == 'V' or arr.dtype.name not in np.sctypeDict:
    raise TypeError(f'variable of dtype {arr.dtype} has no place in '
                    'params.npz: pass it as a torch tensor')
  return arr, None


def _flatten_vars(variables) -> dict:
  flat = {}
  for key, leaf in _dotted(variables).items():
    arr, tag = _leaf_array(leaf)
    key = _SEP.join(key.split('.'))
    if tag is not None:
      flat[key + _DTYPE_TAG] = np.array(tag)
    flat[key] = arr
  return flat


def _unflatten_vars(flat: Mapping[str, np.ndarray]) -> dict:
  """The tree of ``_flatten_vars``, as CPU tensors."""
  tree: dict = {}
  tags = {key[:-len(_DTYPE_TAG)]: str(value)
          for key, value in flat.items() if key.endswith(_DTYPE_TAG)}
  for key, value in flat.items():
    if key.endswith(_DTYPE_TAG):
      continue
    if key in tags:
      if tags[key] != _BF16:
        raise ValueError(f'{key}: stored dtype {tags[key]!r} is not '
                         f'{_BF16!r}')
      tensor = torch.from_numpy(np.ascontiguousarray(value).view(
          np.int16)).view(torch.bfloat16)
    else:
      tensor = torch.from_numpy(np.ascontiguousarray(value))
    node = tree
    parts = key.split(_SEP)
    for part in parts[:-1]:
      node = node.setdefault(part, {})
    node[parts[-1]] = tensor
  return tree


# ---------------------------------------------------------------------------
# Weight-only int8 quantization
# ---------------------------------------------------------------------------

_QVAL = '__q__'
_QSCALE = '__scale__'
# Leaves smaller than this stay float: biases, BN vectors, LayerNorm gains;
# quantizing them saves nothing and costs accuracy.
_Q_MIN_SIZE = 4096


def _quantize_leaf(w: np.ndarray):
  """Symmetric int8 with per-channel scales, on the JAX package's layout.

  Tall matrices (rows >= 4x cols: embedding tables) get per-row scales
  (row norms vary wildly across a vocabulary); everything else (Dense
  kernels [in, out]) per-output-channel scales.
  """
  w = np.asarray(w)
  axis = tuple(range(1, w.ndim)) if w.shape[0] >= 4 * w.shape[-1] \
      else tuple(range(w.ndim - 1))
  amax = np.max(np.abs(w), axis=axis, keepdims=True)
  scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
  q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
  return {_QVAL: q, _QSCALE: scale}


def quantize_variables(variables, transposed: Sequence[str] = ()):
  """Replaces large float matrices with {__q__, __scale__} subtrees.

  ``transposed`` names (dotted) the leaves stored as the transpose of the
  JAX package's layout, ``nn.Linear`` weights ``[out, in]``: their scales
  are taken on the transpose, the flax kernel ``[in, out]``, and the int8
  values and scales are stored back transposed (scales ``[out, 1]``).
  Raises if nothing qualifies: a silent no-op would ship a full-size
  artifact whose manifest claims int8.
  """
  transposed = set(transposed)
  hits = [0]

  def walk(node, name):
    if isinstance(node, Mapping):
      return {k: walk(v, f'{name}{k}.') for k, v in node.items()}
    arr, _ = _leaf_array(node)
    is_float = (node.is_floating_point() if torch.is_tensor(node)
                else np.issubdtype(arr.dtype, np.floating))
    if arr.ndim >= 2 and arr.size >= _Q_MIN_SIZE and is_float:
      hits[0] += 1
      w = (node.detach().cpu().to(torch.float32).numpy()
           if torch.is_tensor(node) else arr.astype(np.float32))
      if name[:-1] in transposed:
        leaf = _quantize_leaf(w.T)
        return {k: np.ascontiguousarray(v.T) for k, v in leaf.items()}
      return _quantize_leaf(w)
    return node

  out = walk(variables, '')
  if not hits[0]:
    raise ValueError(
        'quantize=\'int8\' matched no variables (need float matrices with '
        f'>= {_Q_MIN_SIZE} elements): the artifact would be full-size '
        'while claiming int8; export without quantize instead')
  return out


def dequantize_tree(tree):
  """Inverse of ``quantize_variables`` on tensors: runs inside the
  exported program."""
  if isinstance(tree, Mapping):
    if set(tree) == {_QVAL, _QSCALE}:
      return tree[_QVAL].to(torch.float32) * tree[_QSCALE]
    return {k: dequantize_tree(v) for k, v in tree.items()}
  return tree


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------


class _Apply(nn.Module):
  """The exported function: (variables, context, examples, mask) -> scores.
  The model is held outside the module tree, so that its own tensors are
  neither lifted nor saved: the variables are the program's inputs."""

  def __init__(self, model: nn.Module, quantized: bool):
    super().__init__()
    object.__setattr__(self, '_model', model)
    self.quantized = quantized

  def forward(self, variables, context, examples, mask):
    if self.quantized:
      variables = dequantize_tree(variables)
    return torch.func.functional_call(
        self._model, _dotted(variables), (context, examples, mask),
        {'training': False})


def _sample_inputs(features, batch: int, bucket: Optional[int]):
  """Zeros of each feature's dtype and trailing shape at ``[batch, ...]``
  (context) or ``[batch, bucket, ...]`` (examples)."""
  out = {}
  for name, value in features.items():
    value = torch.as_tensor(value)
    lead = (batch,) if bucket is None else (batch, bucket)
    rest = value.shape[1:] if bucket is None else value.shape[2:]
    out[name] = torch.zeros(lead + tuple(rest), dtype=value.dtype)
  return _sorted_tree(out)


def _strip_device_checks(program) -> list:
  """Takes the trace's tensor-metadata checks out of the program (they
  name the trace's device and check nothing a caller can change); returns
  the devices that other nodes still name."""
  graph = program.graph_module.graph
  for node in list(graph.nodes):
    if node.target is torch.ops.aten._assert_tensor_metadata.default:
      graph.erase_node(node)
  program.graph_module.recompile()
  return sorted({str(a) for node in graph.nodes
                 for a in (*node.args, *node.kwargs.values())
                 if isinstance(a, torch.device)})


def export_predictor(
    model: nn.Module,
    variables: Optional[Mapping[str, Any]],
    context_feature_spec: Mapping[str, parsers.FeatureSpec],
    example_feature_spec: Mapping[str, parsers.FeatureSpec],
    path: str,
    sample_batch: Any,
    list_size_buckets: Sequence[int] = (),
    label_feature_name: Optional[str] = None,
    quantize: Optional[str] = None,
) -> str:
  """Writes a self-contained serving artifact to ``path``.

  ``variables`` are the model's weights: its ``state_dict`` (flat dotted
  names, e.g. from ``convert.from_flax``) or the same as a tree of dicts;
  None takes ``model.state_dict()``. ``sample_batch`` (a RankingBatch or
  anything with ``.context`` / ``.examples`` / ``.mask``) gives each
  feature's trailing shape and dtype; the batch dimension is exported
  symbolically (``torch.export.Dim``, traced at batch 2, so that it is not
  specialized to 1), and the list dimension once per bucket in
  ``list_size_buckets`` (default: the sample's list size), with 1 always
  added for the pointwise ``regress``.

  ``quantize='int8'`` stores every large float matrix (Dense kernels,
  embedding tables) as symmetric int8 with per-channel float scales,
  about 4x smaller, and dequantizes inside the program, so the loader is
  unchanged. Weight-only: activations and the arithmetic stay float.
  """
  example_feature_spec = {k: v for k, v in example_feature_spec.items()
                          if k != label_feature_name}
  # Fail at export, not at the first serve: a spec feature missing from the
  # sample would be left out of the program while the manifest still
  # advertises it.
  missing_ex = sorted(set(example_feature_spec) - set(sample_batch.examples))
  missing_ctx = sorted(set(context_feature_spec) - set(sample_batch.context))
  if missing_ex or missing_ctx:
    raise ValueError(
        'export_predictor: feature spec names absent from sample_batch: '
        f'examples: {missing_ex}, context: {missing_ctx}; the sample must '
        'carry every feature the serving spec will parse')
  sample_examples = {k: v for k, v in dict(sample_batch.examples).items()
                     if k in example_feature_spec}
  sample_context = {k: v for k, v in dict(sample_batch.context).items()
                    if k in context_feature_spec}

  buckets = sorted(set(list_size_buckets)
                   or {int(np.shape(sample_batch.mask)[1])})
  if 1 not in buckets:
    buckets = [1] + buckets
  if quantize is not None and quantize != 'int8':
    raise ValueError(f"quantize must be 'int8' or None, got {quantize!r}")

  if variables is None:
    variables = model.state_dict()
  variables = _as_plain_dicts(_nest(dict(variables)))
  if quantize is not None:
    linear = [f'{name}.weight' for name, m in model.named_modules()
              if isinstance(m, nn.Linear)]
    variables = quantize_variables(variables, transposed=linear)
  # The program's inputs: CPU tensors in a key-sorted tree.
  inputs = _sorted_tree(_unflatten_vars(_flatten_vars(variables)))

  os.makedirs(path, exist_ok=True)
  apply = _Apply(model, quantize is not None)
  batch_dim = torch.export.Dim('batch', min=1)
  devices = set()
  for bucket in buckets:
    context = _sample_inputs(sample_context, 2, None)
    examples = _sample_inputs(sample_examples, 2, bucket)
    mask = torch.ones((2, bucket), dtype=torch.bool)
    dynamic = (torch.utils._pytree.tree_map(lambda _: None, inputs),
               {k: {0: batch_dim} for k in context},
               {k: {0: batch_dim} for k in examples}, {0: batch_dim})
    program = torch.export.export(apply, (inputs, context, examples, mask),
                                  dynamic_shapes=dynamic, strict=False)
    held = list(program.state_dict) + list(program.constants)
    if held:
      raise RuntimeError(f'the exported program holds tensors {held}: the '
                         'weights must be its inputs')
    devices.update(_strip_device_checks(program))
    torch.export.save(program, os.path.join(path, f'apply_L{bucket}.pt2'))

  np.savez(os.path.join(path, _PARAMS), **_flatten_vars(variables))

  manifest = {
      'format_version': 1,
      'context_feature_spec': {k: spec_to_json(v)
                               for k, v in context_feature_spec.items()},
      'example_feature_spec': {k: spec_to_json(v)
                               for k, v in example_feature_spec.items()},
      'list_size_buckets': buckets,
      # Informational: dequantization is inside the exported programs, so
      # the loader needs no special handling.
      'quantize': quantize,
  }
  if devices:
    # The forward made a tensor on the trace's device: recorded, so that
    # loading on another device raises instead of failing mid-request.
    manifest['devices'] = sorted(devices)
  with open(os.path.join(path, _MANIFEST), 'w') as f:
    json.dump(manifest, f, indent=2)
  return path


# ---------------------------------------------------------------------------
# Load
# ---------------------------------------------------------------------------


class ExportedPredictor:
  """Predictor rebuilt from an artifact: no model code needed. The weights
  go to ``device`` once; requests parse on the host as ``Predictor``'s."""

  def __init__(self, path: str, device: DeviceLike = 'cuda'):
    self.device = resolve_device(device)
    with open(os.path.join(path, _MANIFEST)) as f:
      manifest = json.load(f)
    if manifest.get('format_version') != 1:
      raise ValueError(f"Unsupported artifact version: "
                       f"{manifest.get('format_version')!r}")
    named = [torch.device(d) for d in manifest.get('devices', [])]
    if any(d.type != self.device.type for d in named):
      raise ValueError(
          f'the artifact names device(s) {manifest["devices"]} in its '
          f'programs; it cannot serve on {self.device}')
    self.context_feature_spec = {
        k: spec_from_json(v)
        for k, v in manifest['context_feature_spec'].items()}
    self.example_feature_spec = {
        k: spec_from_json(v)
        for k, v in manifest['example_feature_spec'].items()}
    self.buckets = list(manifest['list_size_buckets'])
    self.quantize = manifest.get('quantize')

    with np.load(os.path.join(path, _PARAMS)) as z:
      variables = _unflatten_vars({k: z[k] for k in z.files})
    self.variables = torch.utils._pytree.tree_map(
        lambda t: t.to(self.device), _sorted_tree(variables))

    self._fns = {}
    for bucket in self.buckets:
      program = torch.export.load(os.path.join(path, f'apply_L{bucket}.pt2'))
      self._fns[bucket] = program.module()

  def _bucket_for(self, longest: int) -> int:
    for bucket in self.buckets:
      if bucket >= longest:
        return bucket
    raise ValueError(
        f'Request list size {longest} exceeds the largest exported bucket '
        f'{self.buckets[-1]}; re-export with a larger bucket.')

  def _call(self, bucket: int, context, examples, mask) -> np.ndarray:
    pin = self.device.type == 'cuda'

    def put(a) -> torch.Tensor:
      t = torch.as_tensor(a)
      if pin and t.device.type == 'cpu':
        t = t.pin_memory()
      return t.to(self.device, non_blocking=True)

    with torch.no_grad():
      scores = self._fns[bucket](
          self.variables,
          _sorted_tree({k: put(v) for k, v in context.items()}),
          _sorted_tree({k: put(v) for k, v in examples.items()}), put(mask))
    return scores.cpu().numpy()

  def _run(self, parsed: parsers.ParsedLists, bucket: int) -> np.ndarray:
    return self._call(bucket, parsed.context, parsed.examples, parsed.mask)

  def predict(self, serialized_elwcs: Sequence[bytes]) -> np.ndarray:
    """[B, bucket] scores of serialized ELWC protos (bucketed shapes)."""
    if not serialized_elwcs:
      # Widest exported bucket: buckets[0] is the regress signature's 1.
      return np.zeros((0, self.buckets[-1]), np.float32)
    longest = max(1, int(parsers.elwc_list_sizes(serialized_elwcs).max()))
    bucket = self._bucket_for(longest)
    return self._run(parsers.parse(
        serialized_elwcs, self.context_feature_spec,
        self.example_feature_spec, bucket), bucket)

  def regress(self, serialized_examples: Sequence[bytes]) -> np.ndarray:
    """[B] scores of serialized pointwise tf.Example protos."""
    if not serialized_examples:
      return np.zeros((0,), np.float32)
    return self._run(parsers.parse(
        serialized_examples, self.context_feature_spec,
        self.example_feature_spec, 1, data_format='tf_example'), 1)[:, 0]

  def score_batch(self, batch) -> np.ndarray:
    """Scores a pre-assembled RankingBatch at its exact list size, which
    must be an exported bucket. Features outside the exported specs (a
    training batch's label column) are dropped."""
    list_size = int(np.shape(batch.mask)[1])
    bucket = self._bucket_for(list_size)
    if list_size != bucket:
      raise ValueError(
          f'score_batch requires an exported bucket size; got list size '
          f'{list_size}, buckets {self.buckets}')
    context = {k: v for k, v in dict(batch.context).items()
               if k in self.context_feature_spec}
    examples = {k: v for k, v in dict(batch.examples).items()
                if k in self.example_feature_spec}
    return self._call(bucket, context, examples, batch.mask)


def load_predictor(path: str, device: DeviceLike = 'cuda'
                   ) -> ExportedPredictor:
  return ExportedPredictor(path, device=device)
