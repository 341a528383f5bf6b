"""Pipeline hyperparameter dataclasses.

The port's copy of ``ranking_tpu/pipeline/hparams.py`` (the reference's
``PipelineHparams``/``DatasetHparams``,
tensorflow_ranking/python/keras/pipeline.py:261-366). The knobs are the
same, so a config translates one to one. The mesh sizes stay for that
reason, but one H100 is a mesh of one: ``mesh_data`` and ``mesh_model``
other than None or 1 raise.

``lr_schedule_from_hparams``, ``optimizer_from_hparams`` and
``sparse_optimizer_from_hparams`` return the port's optimizer factories
(``train/state.py``) and its ``LazyAdam``/``LazyAdagrad``. A schedule is a
function of the 0-based update count, an int32 tensor on the device, with
optax's formulas, so that it is evaluated inside the step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Union

import torch

from ranking_tpu_torch.train import state as state_lib


@dataclasses.dataclass
class PipelineHparams:
  model_dir: str
  num_epochs: int
  steps_per_epoch: int
  validation_steps: int
  learning_rate: float
  loss: Union[str, Mapping[str, str]]
  loss_weights: Optional[Union[float, Mapping[str, float]]] = None
  optimizer: str = 'adam'   # 'adam' | 'adagrad' | 'sgd' | 'adamw' |
                            # 'lazy_adam' | 'lazy_adagrad' (sparse-row embedding updates)
  loss_reduction: str = 'sum_by_nonzero_weights'
  # K train steps per dispatch; on CUDA one captured graph replayed K times.
  steps_per_execution: int = 10
  export_best_model: bool = False
  # The reference's default (keras/pipeline.py:327): the monitored metric
  # is 'loss', for which lower is better.
  best_exporter_metric_higher_better: bool = False
  best_exporter_metric: str = 'loss'
  automatic_reduce_lr: bool = False
  # 'constant' | 'linear_decay' (power 1 from learning_rate to
  # end_learning_rate over the steps after the warmup) | 'cosine_decay';
  # warmup_steps > 0 puts a 0 -> learning_rate linear ramp in front. Not
  # with automatic_reduce_lr, which owns the rate at epoch granularity.
  lr_schedule: str = 'constant'
  warmup_steps: int = 0
  end_learning_rate: float = 0.0
  # Global-norm gradient clipping (0 = off).
  gradient_clip_norm: float = 0.0
  early_stopping_patience: int = 0
  early_stopping_min_delta: float = 0.0
  use_weighted_metrics: bool = False
  # Optional per-example weight feature: feeds the loss and, with
  # use_weighted_metrics, the metric suite.
  weights_feature_name: Optional[str] = None
  # The (data, model) mesh over the ranks of the process group
  # (parallel/mesh.py): None data is the largest divisor of the global
  # batch that fits world // mesh_model.
  mesh_data: Optional[int] = None
  mesh_model: int = 1
  seed: Optional[int] = 1
  # torch.profiler trace of one epoch, written as a Chrome trace.
  profile_dir: Optional[str] = None
  profile_epoch: int = 1
  # Deterministic data resume: a restored pipeline fast-forwards the
  # seeded train stream by the restored step count, one batch a completed
  # step, so that a resumed run consumes the batches of an uninterrupted
  # one. False restarts the stream from the top, as the reference does.
  resume_dataset: bool = False


@dataclasses.dataclass
class DatasetHparams:
  train_input_pattern: str
  valid_input_pattern: str
  train_batch_size: int
  valid_batch_size: int
  list_size: Optional[int] = None
  valid_list_size: Optional[int] = None
  dataset_reader: str = 'example_list_with_context'
  convert_labels_to_binary: bool = False
  shuffle_buffer_size: int = 1000
  mask_feature_name: Optional[str] = None
  label_feature_name: str = 'relevance'
  size_feature_name: Optional[str] = None
  interleave_files: int = 1
  dataset_engine: str = 'auto'
  dataset_cache: Optional[str] = None


def from_yaml(path: str):
  """Loads ``(PipelineHparams, DatasetHparams)`` from a YAML file whose
  top-level keys ``pipeline:`` and ``dataset:`` map onto the fields."""
  import yaml
  with open(path) as f:
    cfg = yaml.safe_load(f) or {}

  def _build(cls, section):
    data = dict(cfg.get(section) or {})
    valid = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - valid
    if unknown:
      raise ValueError(f'Unknown {section} config keys: {sorted(unknown)}')
    return cls(**data)

  return _build(PipelineHparams, 'pipeline'), _build(DatasetHparams,
                                                     'dataset')


def polynomial_schedule(init_value: float, end_value: float, power: float,
                        transition_steps: int) -> state_lib.Schedule:
  """``optax.polynomial_schedule`` (transition_begin 0)."""
  def schedule(count):
    count = torch.clamp(count, 0, transition_steps)
    frac = 1 - count / transition_steps
    return (init_value - end_value) * (frac ** power) + end_value
  return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> state_lib.Schedule:
  """``optax.cosine_decay_schedule`` (exponent 1)."""
  def schedule(count):
    count = torch.clamp(count.to(torch.float32), max=float(decay_steps))
    cosine_decay = 0.5 * (1 + torch.cos(math.pi * count / float(decay_steps)))
    decayed = (1 - alpha) * cosine_decay ** 1.0 + alpha
    return init_value * decayed
  return schedule


def join_schedules(first: state_lib.Schedule, then: state_lib.Schedule,
                   boundary: int) -> state_lib.Schedule:
  """``optax.join_schedules([first, then], [boundary])``."""
  def schedule(count):
    return torch.where(count < boundary, first(count),
                       then(count - boundary))
  return schedule


def lr_schedule_from_hparams(hparams: PipelineHparams):
  """The per-step learning-rate schedule, or a float for a constant rate."""
  kind = hparams.lr_schedule.lower()
  lr = hparams.learning_rate
  warmup = max(0, int(hparams.warmup_steps))
  if kind not in ('constant', 'linear_decay', 'cosine_decay'):
    raise ValueError(
        f'Unknown lr_schedule {hparams.lr_schedule!r}; one of constant, '
        'linear_decay, cosine_decay')
  if (kind != 'constant' or warmup) and hparams.automatic_reduce_lr:
    raise ValueError(
        'lr_schedule/warmup_steps and automatic_reduce_lr are mutually '
        'exclusive: the plateau hook owns the LR at epoch granularity')
  if kind == 'constant' and not warmup:
    return lr
  total = max(1, hparams.num_epochs * hparams.steps_per_epoch)
  decay_steps = max(1, total - warmup)
  if kind == 'linear_decay':
    decay = polynomial_schedule(lr, hparams.end_learning_rate, 1.0,
                                decay_steps)
  elif kind == 'cosine_decay':
    decay = cosine_decay_schedule(
        lr, decay_steps, (hparams.end_learning_rate / lr) if lr else 0.0)
  else:
    decay = lambda count: torch.full_like(count, lr, dtype=torch.float32)  # noqa: E731
  if not warmup:
    return decay
  return join_schedules(polynomial_schedule(0.0, lr, 1.0, warmup), decay,
                        warmup)


def optimizer_from_hparams(hparams: PipelineHparams
                           ) -> state_lib.OptimizerFactory:
  """The dense optimizer's factory. Under ``automatic_reduce_lr`` the
  pipeline scales the optimizer's rate tensor (``optimizer.lr``) in place;
  clipping is inside the optimizer either way."""
  name = hparams.optimizer.lower()
  lr = lr_schedule_from_hparams(hparams)
  if name == 'lazy_adam':  # dense params ride plain adam
    name = 'adam'
  elif name == 'lazy_adagrad':  # dense params ride plain adagrad
    name = 'adagrad'
  factories = {'adam': state_lib.adam, 'adagrad': state_lib.adagrad,
               'sgd': state_lib.sgd, 'adamw': state_lib.adamw}
  if name not in factories:
    raise ValueError(f'Unknown optimizer {hparams.optimizer!r}')
  clip = (float(hparams.gradient_clip_norm)
          if hparams.gradient_clip_norm and hparams.gradient_clip_norm > 0
          else None)
  return factories[name](lr, clip_norm=clip)


def sparse_optimizer_from_hparams(hparams: PipelineHparams):
  """The lazy-row optimizer when ``optimizer`` is 'lazy_adam' or
  'lazy_adagrad' (embedding tables get sparse-row updates,
  ``train/sparse.py``), else None."""
  name = hparams.optimizer.lower()
  if name not in ('lazy_adam', 'lazy_adagrad'):
    return None
  if hparams.automatic_reduce_lr:
    raise ValueError(
        f"optimizer={name!r} does not support automatic_reduce_lr "
        '(the plateau hook rewrites only the dense optimizer)')
  if (hparams.lr_schedule.lower() != 'constant' or hparams.warmup_steps
      or (hparams.gradient_clip_norm and hparams.gradient_clip_norm > 0)):
    raise ValueError(
        f'optimizer={name!r} supports constant learning rate only: the '
        'sparse row updates apply hparams.learning_rate directly, so a '
        'schedule/warmup/clip would silently diverge between the dense '
        'and sparse parameter groups')
  from ranking_tpu_torch.train.sparse import LazyAdagrad, LazyAdam
  cls = LazyAdam if name == 'lazy_adam' else LazyAdagrad
  return cls(learning_rate=hparams.learning_rate)
