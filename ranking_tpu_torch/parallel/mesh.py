"""The ``(data, model)`` grid of ranks, sharding rules and batch shards.

The port's copy of ``ranking_tpu/parallel/mesh.py``. The JAX package lays
one ``jax.sharding.Mesh`` over its devices and lets XLA's SPMD partitioner
insert the collectives; here each rank is a process with one device (a card
under NCCL, the CPU under gloo), the mesh is the grid of those processes,
and the port's modules and steps call the collectives themselves
(``parallel/comm.py``):

* ``data``: batch parallelism. Each rank of a data group holds the same
  parameters and a contiguous block of the global batch's rows; batch
  statistics and gradients are summed over the group.
* ``model``: parameter sharding. The ranks of a model group hold the same
  rows of the batch and one slice each of the parameters that a rule shards
  (embedding tables by rows; the encoder's heads and MLP under
  ``ENCODER_TP_RULES``).

Rank ``r`` sits at ``(r // model, r % model)``: adjacent ranks share a model
group, as adjacent devices do in the JAX package's mesh. A rule's spec is
the JAX package's ``PartitionSpec`` as a tuple (``(MODEL_AXIS, None)``):
the position of ``MODEL_AXIS`` in it is the dimension that is split over
the model group, and a parameter whose dimension the group's size does not
divide stays whole on every rank (the ``MinSizePartitioner`` fallback).

A mesh of one (``make_mesh()`` with no process group) is the identity:
every collective returns its input.
"""

from __future__ import annotations

import os
import re
import warnings
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from ranking_tpu_torch.data.batch import RankingBatch
from ranking_tpu_torch.utils.device import DeviceLike, resolve_device

Tensor = torch.Tensor

DATA_AXIS = 'data'
MODEL_AXIS = 'model'

Spec = Tuple[Optional[str], ...]

# (param-path regex, spec); the first match wins and parameters with no
# match are replicated. Embedding tables (models/embeddings.py and
# parallel/embedding.py name the table 'embedding') and their LazyAdam
# moments ('<table path>/m', '/v') shard rows over the model axis.
DEFAULT_RULES: Tuple[Tuple[str, Spec], ...] = (
    (r'.*\bembedding\b(?:/(?:m|v))?$', (MODEL_AXIS, None)),
)

# Megatron's layout of the transformer encoder (models/encoder.py): q/k/v
# split over the heads and the MLP's first Dense over its output (column
# parallel, no communication in the forward), the attention's out
# projection and the MLP's second Dense over their contracted axis (row
# parallel, one all-reduce each). Heads or mlp_dim that the model axis
# does not divide stay replicated, parameter by parameter.
ENCODER_TP_RULES: Tuple[Tuple[str, Spec], ...] = (
    (r'.*/(query|key|value)/kernel$', (None, MODEL_AXIS, None)),
    (r'.*/(query|key|value)/bias$', (MODEL_AXIS, None)),
    (r'.*/out/kernel$', (MODEL_AXIS, None, None)),
    (r'.*block_\d+/Dense_0/kernel$', (None, MODEL_AXIS)),
    (r'.*block_\d+/Dense_0/bias$', (MODEL_AXIS,)),
    (r'.*block_\d+/Dense_1/kernel$', (MODEL_AXIS, None)),
) + DEFAULT_RULES


class Mesh:
  """This process's place in the ``(data, model)`` grid and its groups.

  ``rank`` is the global rank, ``data_index``/``model_index`` its grid
  coordinates, ``data_group`` the ranks that share its ``model_index`` (it
  sums gradients and batch statistics), ``model_group`` those that share
  its ``data_index`` (it assembles sharded parameters), ``grid_group`` all
  the grid's ranks. A group is None where no process group is up (a mesh
  of one) and along an axis of size 1, where its collectives would do no
  work: they are then the identity. Ranks past ``data * model`` are outside
  the grid (``member`` False), in no group, and idle.
  """

  def __init__(self, data: int, model: int, rank: int = 0,
               data_group=None, model_group=None, grid_group=None,
               backend: str = 'none'):
    self.data = data
    self.model = model
    self.rank = rank
    self.data_group = data_group
    self.model_group = model_group
    self.grid_group = grid_group
    self.backend = backend

  # Process groups do not copy; a deep copy of a model keeps its mesh.
  def __deepcopy__(self, memo):
    return self

  def __repr__(self):
    return (f'Mesh(data={self.data}, model={self.model}, rank={self.rank}, '
            f'backend={self.backend!r})')

  @property
  def shape(self) -> Dict[str, int]:
    return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

  @property
  def size(self) -> int:
    return self.data * self.model

  @property
  def member(self) -> bool:
    return self.rank < self.size

  @property
  def data_index(self) -> int:
    return self.rank // self.model

  @property
  def model_index(self) -> int:
    return self.rank % self.model

  @property
  def distributed(self) -> bool:
    """Whether a process group is up under the grid."""
    return self.grid_group is not None

  def group(self, axis: str):
    if axis == DATA_AXIS:
      return self.data_group
    if axis == MODEL_AXIS:
      return self.model_group
    raise ValueError(f'unknown mesh axis {axis!r}')

  def row_block(self, n: int) -> Tuple[int, int]:
    """This rank's ``[start, stop)`` of ``n`` global rows."""
    if n % self.data:
      raise ValueError(f'{n} rows do not divide over data={self.data}')
    per = n // self.data
    return self.data_index * per, (self.data_index + 1) * per


def init_distributed(device: DeviceLike = 'cuda',
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None) -> torch.device:
  """Brings up the default process group and returns this rank's device.

  Without arguments it reads torchrun's ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT`` (``env://``). On
  ``device='cuda'`` the rank takes card ``LOCAL_RANK`` and NCCL; on
  ``device='cpu'`` gloo. ``backend`` overrides the choice (gloo over CUDA
  tensors, whose collectives then pass through host memory). A missing
  card raises unless ``device='cpu'`` was asked for; a backend that fails
  to come up raises."""
  import torch.distributed as dist
  device = resolve_device(device)
  rank = int(os.environ.get('RANK', 0)) if rank is None else rank
  world_size = (int(os.environ.get('WORLD_SIZE', 1)) if world_size is None
                else world_size)
  if device.type == 'cuda':
    # Ranks past the cards share them (gloo only: NCCL refuses two ranks
    # on one card).
    local = int(os.environ.get('LOCAL_RANK', rank))
    device = torch.device('cuda', local % torch.cuda.device_count()
                          if device.index is None else device.index)
    torch.cuda.set_device(device)
  backend = backend or ('nccl' if device.type == 'cuda' else 'gloo')
  if not dist.is_initialized():
    kwargs = {}
    if backend == 'nccl':
      kwargs['device_id'] = device
    dist.init_process_group(backend, init_method=init_method or 'env://',
                            world_size=world_size, rank=rank, **kwargs)
  return device


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
  """The ``(data, model)`` mesh over the ranks of the default process
  group (one rank, and no group, if none is up).

  With ``data=None`` every rank goes to the data axis after ``model``:
  pure data parallelism when ``model == 1``. ``data * model`` may be below
  the world size: the ranks past it idle (``member`` False). Every rank
  must call this, in the same order as its other group creations."""
  import torch.distributed as dist
  up = dist.is_available() and dist.is_initialized()
  world = dist.get_world_size() if up else 1
  rank = dist.get_rank() if up else 0
  if data is None:
    if world % model:
      raise ValueError(f'{world} ranks not divisible by model={model}')
    data = world // model
  if data < 1 or model < 1:
    raise ValueError(f'mesh {data}x{model}')
  if data * model > world:
    raise ValueError(f'mesh {data}x{model} exceeds {world} ranks')
  if not up:
    return Mesh(data, model, rank)
  data_group = model_group = None
  # Every rank creates every group, in one order (new_group's contract). An
  # axis of size 1 gets none: its collectives are the identity.
  for m in range(model if data > 1 else 0):
    ranks = [d * model + m for d in range(data)]
    g = dist.new_group(ranks)
    if rank in ranks:
      data_group = g
  for d in range(data if model > 1 else 0):
    ranks = [d * model + m for m in range(model)]
    g = dist.new_group(ranks)
    if rank in ranks:
      model_group = g
  grid_group = dist.new_group(list(range(data * model)))
  return Mesh(data, model, rank, data_group, model_group,
              grid_group if rank < data * model else None,
              backend=str(dist.get_backend()))


def _divisible(shape: Sequence[int], spec: Spec, mesh: Mesh) -> bool:
  if len(spec) > len(shape):
    return False
  for dim, axis in zip(shape, spec):
    if axis is not None and dim % mesh.shape[axis]:
      return False
  return True


def spec_dim(spec: Spec) -> Optional[int]:
  """The dimension a spec splits over the model axis, or None."""
  return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def param_shardings(params: Mapping[str, Any], mesh: Mesh,
                    rules: Sequence[Tuple[str, Spec]] = DEFAULT_RULES
                    ) -> Dict[str, Optional[int]]:
  """``{path: dim}``: the dimension of each parameter (keyed by its
  '/'-joined path, values anything with a ``shape``) that is split over the
  model axis, or None for a replicated one. A rule whose parameter is too
  small, or not divisible along the split axis, is downgraded to
  replication (the reference's ``MinSizePartitioner``,
  keras/strategy_utils.py:104-113); the first matching rule decides."""
  compiled = [(re.compile(pat), tuple(spec)) for pat, spec in rules]
  out: Dict[str, Optional[int]] = {}
  for path, leaf in params.items():
    out[path] = None
    for pat, spec in compiled:
      if pat.match(path):
        if _divisible(tuple(getattr(leaf, 'shape', ())), spec, mesh):
          out[path] = spec_dim(spec)
        break
  return out


def local_slice(x: Tensor, dim: Optional[int], mesh: Mesh) -> Tensor:
  """This rank's slice of a whole tensor split over the model axis along
  ``dim`` (the tensor itself for None)."""
  if dim is None or mesh.model == 1:
    return x
  size = x.shape[dim] // mesh.model
  return x.narrow(dim, mesh.model_index * size, size)


def sharded_dims(model: nn.Module) -> Dict[str, int]:
  """``{state_dict name: dim}`` of the model's parameters that are split
  over the model axis (``shard_module``, ``ShardedEmbeddingEncoder``)."""
  out = {}
  for prefix, module in model.named_modules():
    for name, dim in getattr(module, 'model_shards', {}).items():
      out[f'{prefix}.{name}' if prefix else name] = dim
  return out


def mark_sharded(module: nn.Module, name: str, dim: int, mesh: Mesh) -> None:
  """Records that ``module``'s parameter ``name`` holds this rank's slice
  along ``dim``."""
  shards = dict(module.__dict__.get('model_shards', {}))
  shards[name] = dim
  module.__dict__['model_shards'] = shards
  module.__dict__['mesh'] = mesh


def shard_module(model: nn.Module, mesh: Mesh,
                 rules: Sequence[Tuple[str, Spec]] = DEFAULT_RULES
                 ) -> nn.Module:
  """Replaces, in place, each parameter that a rule shards by this rank's
  slice (``param_shardings`` on the whole shapes), and marks it. Call it on
  a model that holds the whole parameters, before its optimizer is built;
  the modules then call their collectives (the sharded lookups, the tensor-
  parallel encoder). Parameters already sharded are left as they are. With
  ``mesh.model == 1`` nothing is split."""
  if mesh.model == 1:
    return model
  done = sharded_dims(model)
  params = {n.replace('.', '/'): p for n, p in model.named_parameters()
            if n not in done}
  for path, dim in param_shardings(params, mesh, rules).items():
    if dim is None:
      continue
    mod_name, _, name = path.rpartition('/')
    module = model.get_submodule(mod_name.replace('/', '.'))
    whole = getattr(module, name)
    setattr(module, name, nn.Parameter(
        local_slice(whole.detach(), dim, mesh).clone(),
        requires_grad=whole.requires_grad))
    mark_sharded(module, name, dim, mesh)
  return model


def shard_state_dict(full: Mapping[str, Tensor], model: nn.Module,
                     mesh: Mesh) -> Dict[str, Tensor]:
  """This rank's ``state_dict`` from a whole one (keyed as the model's):
  the sharded entries sliced, the rest as they are."""
  dims = sharded_dims(model)
  return {k: (local_slice(v, dims[k], mesh) if k in dims else v)
          for k, v in full.items()}


def gather_state_dict(local: Mapping[str, Tensor], model: nn.Module,
                      mesh: Mesh) -> Dict[str, Tensor]:
  """The whole ``state_dict`` from every rank's shards (a collective over
  the model group: every rank calls it)."""
  from ranking_tpu_torch.parallel import comm
  dims = sharded_dims(model)
  return {k: (comm.all_gather(v, mesh.model_group, dims[k])
              if k in dims and mesh.model > 1 else v)
          for k, v in local.items()}


def shard_batch(batch: RankingBatch, mesh: Mesh) -> RankingBatch:
  """This rank's rows of a global batch: the contiguous block
  ``row_block`` of every leaf's leading axis (``[B, ...]`` leaves, and
  flat ``[B*L, ...]`` example leaves by whole lists)."""
  if mesh.data == 1:
    return batch
  b = batch.mask.shape[0]
  lo, hi = mesh.row_block(b)

  def rows(x: Tensor) -> Tensor:
    if x.ndim >= 1 and x.shape[0] == b:
      return x[lo:hi]
    if x.ndim >= 1 and x.shape[0] % b == 0:   # flat [B*L, ...]
      per = x.shape[0] // b
      return x[lo * per:hi * per]
    raise ValueError(f'leaf of shape {tuple(x.shape)} has no batch axis '
                     f'of {b}')

  labels = ({k: rows(v) for k, v in batch.labels.items()}
            if isinstance(batch.labels, dict) else rows(batch.labels))
  return RankingBatch(
      context={k: rows(v) for k, v in batch.context.items()},
      examples={k: rows(v) for k, v in batch.examples.items()},
      labels=labels, mask=rows(batch.mask))


def local_batch_to_global(batch: RankingBatch, mesh: Mesh) -> RankingBatch:
  """The global batch from every rank's rows (a collective over the data
  group: every rank calls it): the multi-host feed, where each process
  reads its own files."""
  from ranking_tpu_torch.parallel import comm
  if mesh.data == 1 or not mesh.distributed:
    return batch
  g = lambda x: comm.all_gather(x, mesh.data_group, 0)  # noqa: E731
  labels = ({k: g(v) for k, v in batch.labels.items()}
            if isinstance(batch.labels, dict) else g(batch.labels))
  return RankingBatch(
      context={k: g(v) for k, v in batch.context.items()},
      examples={k: g(v) for k, v in batch.examples.items()},
      labels=labels, mask=g(batch.mask))


def default_data_size(batch_size: int, world: int, model: int) -> int:
  """The largest divisor of the global batch that fits ``world // model``
  ranks, with the JAX package's warning when ranks stay idle."""
  avail = max(1, world // model)
  data = max(d for d in range(1, avail + 1) if batch_size % d == 0)
  if data < avail:
    warnings.warn(
        f'train_batch_size {batch_size} does not divide over {avail} '
        f'ranks; using a {data}-way data axis ({avail - data} ranks idle). '
        f'Pick a batch size with a larger divisor or set mesh_data '
        f'explicitly.')
  return data


def batch_sharding(mesh: Mesh) -> Spec:
  """The spec of a batch leaf: its leading axis split over ``data``."""
  return (DATA_AXIS,)


def replicated(mesh: Mesh) -> Spec:
  """The spec of a replicated leaf."""
  return ()


def shard_params(params: Mapping[str, Any], mesh: Mesh,
                 rules: Sequence[Tuple[str, Spec]] = DEFAULT_RULES
                 ) -> Dict[str, Tensor]:
  """This rank's slice of each whole parameter of ``{path: tensor or
  array}``, by ``param_shardings``."""
  dims = param_shardings(params, mesh, rules)
  return {p: local_slice(torch.as_tensor(v), dims[p], mesh)
          for p, v in params.items()}
