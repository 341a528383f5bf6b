"""Checkpoint, resume and export over ``torch.save``.

The port's copy of ``ranking_tpu/train/checkpoint.py``, which keeps Orbax
checkpoints of the ``TrainState`` pytree (the reference's
``BackupAndRestore``, ``ModelCheckpoint(save_best_only)`` and its latest
and best exports, keras/pipeline.py:492-510,634-650). A checkpoint here is
one file, ``ckpt_<step>.pt``: the model's parameters and buffers (so the
batch statistics and, for a sparse model, the tables), the optimizer's
state with its step and rate tensors, the lazy-row optimizer's state, the
step and the state's generator. Its metrics lie beside it in
``ckpt_<step>.json``. Every file is written to a temp name and renamed, so a
reader never finds half of one.

Under a mesh (``parallel/``) the files hold the whole state, in the same
format: every rank gathers its shards over its model group, the first rank
alone writes, and every rank restores by taking its slices of the whole
tensors. So a checkpoint of one mesh restores on another, and on one card,
where the padded table of a ``ShardedEmbeddingEncoder`` has the same rows
(ranking_tpu/parallel/embedding.py:128-140).
"""

from __future__ import annotations

import copy
import glob
import json
import os
import re
from typing import Any, Dict, Mapping, Optional

import torch

from ranking_tpu_torch.train.state import TrainState


def _atomic_save(obj: Any, path: str) -> None:
  tmp = f'{path}.{os.getpid()}.tmp'
  torch.save(obj, tmp)
  os.replace(tmp, path)


def _atomic_json(obj: Any, path: str) -> None:
  tmp = f'{path}.{os.getpid()}.tmp'
  with open(tmp, 'w') as f:
    json.dump(obj, f)
  os.replace(tmp, path)


class _Dir:
  """One directory of ``ckpt_<step>.pt`` files and their metrics."""

  def __init__(self, directory: str):
    self.directory = directory
    os.makedirs(directory, exist_ok=True)

  def path(self, step: int) -> str:
    return os.path.join(self.directory, f'ckpt_{step}.pt')

  def steps(self):
    found = []
    for p in glob.glob(os.path.join(self.directory, 'ckpt_*.pt')):
      m = re.fullmatch(r'ckpt_(\d+)\.pt', os.path.basename(p))
      if m:
        found.append(int(m.group(1)))
    return sorted(found)

  def metrics(self, step: int) -> Optional[Dict[str, float]]:
    try:
      with open(self.path(step)[:-3] + '.json') as f:
        return json.load(f)
    except (OSError, ValueError):
      return None

  def write(self, step: int, payload: Mapping[str, Any],
            metrics: Mapping[str, float]) -> None:
    _atomic_json(dict(metrics), self.path(step)[:-3] + '.json')
    _atomic_save(payload, self.path(step))

  def keep_latest(self, n: int) -> None:
    for step in self.steps()[:-n]:
      for path in (self.path(step), self.path(step)[:-3] + '.json'):
        if os.path.exists(path):
          os.remove(path)


def _payload(state: TrainState) -> Dict[str, Any]:
  out = {'step': int(state.step),
         'model': state.model.state_dict(),
         'optimizer': state.optimizer.state_dict()}
  if state.sparse_opt_state is not None:
    out['sparse_opt_state'] = state.sparse_opt_state
  if state.generator is not None:
    out['generator'] = state.generator.get_state()
  return out


def _map_sharded(payload: Mapping[str, Any], state: TrainState, fn
                 ) -> Dict[str, Any]:
  """``payload`` with ``fn(tensor, dim)`` applied to each tensor that is
  split over the model group along ``dim``: sharded parameters, their
  moments in the optimizer's state and in the lazy-row optimizer's."""
  from ranking_tpu_torch.parallel import mesh as mesh_lib
  dims = mesh_lib.sharded_dims(state.model)
  if not dims:
    return dict(payload)
  by_id = {id(p): dims[n] for n, p in state.model.named_parameters()
           if n in dims}
  out = dict(payload)
  out['model'] = {k: (fn(v, dims[k]) if k in dims else v)
                  for k, v in payload['model'].items()}
  if payload.get('optimizer') is not None and state.optimizer is not None:
    params = [p for g in state.optimizer.param_groups for p in g['params']]
    opt = dict(payload['optimizer'])
    opt['state'] = {
        i: ({k: (fn(v, by_id[id(params[i])])
                 if torch.is_tensor(v) and v.ndim > 0 else v)
             for k, v in entry.items()}
            if id(params[i]) in by_id else entry)
        for i, entry in payload['optimizer']['state'].items()}
    out['optimizer'] = opt
  if 'sparse_opt_state' in payload:
    paths = {n.replace('.', '/'): d for n, d in dims.items()}
    out['sparse_opt_state'] = {
        k: ({kk: fn(vv, paths[k]) for kk, vv in v.items()}
            if isinstance(v, dict) and k in paths else v)
        for k, v in payload['sparse_opt_state'].items()}
  return out


def _whole(payload: Mapping[str, Any], state: TrainState, mesh
           ) -> Dict[str, Any]:
  """The payload with every shard gathered over the model group (a
  collective: every rank calls it)."""
  from ranking_tpu_torch.parallel import comm
  return _map_sharded(
      payload, state,
      lambda v, d: comm.all_gather(v, mesh.model_group, d))


def _slices(payload: Mapping[str, Any], state: TrainState, mesh
            ) -> Dict[str, Any]:
  """This rank's slices of a whole payload."""
  from ranking_tpu_torch.parallel import mesh as mesh_lib
  return _map_sharded(
      payload, state, lambda v, d: mesh_lib.local_slice(v, d, mesh).clone(
          memory_format=torch.contiguous_format))


def _barrier(mesh) -> None:
  """Every rank of the grid waits for the first rank's write."""
  if mesh is not None and mesh.distributed:
    import torch.distributed as dist
    dist.barrier(group=mesh.grid_group)


def _load_into(state: TrainState, ckpt: Mapping[str, Any]) -> TrainState:
  """Copies a checkpoint into ``state``'s own tensors, in place."""
  if ('sparse_opt_state' in ckpt) != (state.sparse_opt_state is not None):
    raise ValueError('sparse_opt_state present on one side only')
  state.model.load_state_dict(ckpt['model'])
  state.optimizer.load_state_dict(ckpt['optimizer'])
  if state.sparse_opt_state is not None:
    _copy_tree(state.sparse_opt_state, ckpt['sparse_opt_state'])
  if state.generator is not None and 'generator' in ckpt:
    state.generator.set_state(ckpt['generator'].cpu())
  state.step = int(ckpt['step'])
  return state


def _copy_tree(dst: Dict[str, Any], src: Mapping[str, Any]) -> None:
  if set(dst) != set(src):
    raise KeyError(f'sparse state keys {sorted(src)} != {sorted(dst)}')
  for k, v in dst.items():
    if isinstance(v, dict):
      _copy_tree(v, src[k])
    else:
      v.copy_(src[k])


class CheckpointManager:
  """Latest N plus the single best-by-metric checkpoint of a TrainState.

  ``<dir>`` keeps the latest ``max_to_keep`` (resume always from the true
  latest) and ``<dir>/best`` the one best by ``best_metric`` (for export).
  A best write that is not strictly better than the kept one is skipped.
  """

  def __init__(self, directory: str, max_to_keep: int = 3,
               best_metric: Optional[str] = None,
               best_mode: str = 'max', mesh=None):
    self.mesh = mesh
    self.directory = os.path.abspath(directory)
    self.max_to_keep = max_to_keep
    self.best_metric = best_metric
    self.best_mode = best_mode
    self._latest = _Dir(self.directory)
    self._best = (_Dir(os.path.join(self.directory, 'best'))
                  if best_metric else None)

  def save(self, state: TrainState,
           metrics: Optional[Mapping[str, float]] = None) -> None:
    step = int(state.step)
    metrics = {k: float(v) for k, v in (metrics or {}).items()}
    payload = _payload(state)
    if self.mesh is not None:
      payload = _whole(payload, state, self.mesh)
      if self.mesh.rank == 0:
        self._save(step, payload, metrics)
      _barrier(self.mesh)
      return
    self._save(step, payload, metrics)

  def _save(self, step: int, payload: Mapping[str, Any],
            metrics: Mapping[str, float]) -> None:
    self._latest.write(step, payload, metrics)
    self._latest.keep_latest(self.max_to_keep)
    if self._best is None or not metrics:
      return
    if self.best_metric not in metrics:
      raise ValueError(
          f'best_metric {self.best_metric!r} missing from save metrics '
          f'{sorted(metrics)}')
    prev_step = self.best_step()
    if prev_step is not None:
      prev = (self._best.metrics(prev_step) or {}).get(self.best_metric)
      if prev is not None:
        current = metrics[self.best_metric]
        if (current <= prev if self.best_mode == 'max' else current >= prev):
          return
    self._best.write(step, payload, metrics)
    self._best.keep_latest(1)

  def _read(self, where: _Dir, step: int, state: TrainState) -> Dict:
    ckpt = torch.load(where.path(step), map_location=state.device,
                      weights_only=True)
    if self.mesh is not None:
      ckpt = _slices(ckpt, state, self.mesh)
    return ckpt

  def restore(self, state: TrainState) -> TrainState:
    """Restores the latest checkpoint into ``state``, in place; a fresh
    directory leaves it as it is. Writes are synchronous, so the latest
    file is whole."""
    step = self.latest_step()
    if step is None:
      return state
    try:
      return _load_into(state, self._read(self._latest, step, state))
    except (ValueError, KeyError, RuntimeError) as e:
      raise ValueError(
          f'Checkpoint at {self.directory} step {step} does not match the '
          f'current TrainState structure — commonly a sparse/dense '
          f'optimizer toggle (sparse_opt_state present on one side only). '
          f'Use a fresh model_dir or the original optimizer. '
          f'Original error: {e}') from e

  def restore_best(self, state: TrainState) -> TrainState:
    """A state for export or evaluation: a copy of ``state``'s model with
    the best checkpoint's parameters and buffers, at its step, and no
    optimizer. ``state`` is left as it is; without a best checkpoint it is
    returned."""
    step = self.best_step()
    if step is None:
      return state
    ckpt = self._read(self._best, step, state)
    model = copy.deepcopy(state.model)
    try:
      model.load_state_dict(ckpt['model'])
    except RuntimeError as e:
      raise ValueError(
          f'Best checkpoint at {self.directory}/best step {step} does not '
          f'match the current TrainState structure. Use a fresh model_dir '
          f'or the original model. Original error: {e}') from e
    return TrainState(model=model, optimizer=None, step=int(ckpt['step']))

  def latest_step(self) -> Optional[int]:
    steps = self._latest.steps()
    return steps[-1] if steps else None

  def best_step(self) -> Optional[int]:
    if self._best is None:
      return None
    steps = self._best.steps()
    return steps[-1] if steps else None


def export_params(state: TrainState, path: str, mesh=None) -> None:
  """Inference export: the model's parameters and buffers in
  ``<path>/params.pt``, replacing an earlier export. Under ``mesh`` the
  whole ones, gathered by every rank and written by the first."""
  sd = state.model.state_dict()
  if mesh is not None:
    from ranking_tpu_torch.parallel import mesh as mesh_lib
    sd = mesh_lib.gather_state_dict(sd, state.model, mesh)
    if mesh.rank != 0:
      _barrier(mesh)
      return
  os.makedirs(path, exist_ok=True)
  _atomic_save(sd, os.path.join(path, 'params.pt'))
  _barrier(mesh)


def load_params(path: str) -> Dict[str, torch.Tensor]:
  """The exported ``state_dict``, on the CPU (``Predictor`` and
  ``load_state_dict`` take it as it is)."""
  return torch.load(os.path.join(path, 'params.pt'), map_location='cpu',
                    weights_only=True)


def write_metrics_log(directory: str, step: int,
                      metrics: Mapping[str, float]) -> None:
  """Appends a JSON line of metric values to ``<directory>/metrics.jsonl``."""
  os.makedirs(directory, exist_ok=True)
  with open(os.path.join(directory, 'metrics.jsonl'), 'a') as f:
    f.write(json.dumps({'step': int(step),
                        **{k: float(v) for k, v in metrics.items()}}) + '\n')
