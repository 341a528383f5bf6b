"""The feed-forward scorer over MSLR-shaped lists: the program's
``RankingModel(DNNScorer(...), 'log1p')``, its weights, inputs and work,
and its plain reference (``cardbench/reference/dnn.py``)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from cardbench import synth, work
from cardbench.reference import dnn as ref_dnn

Tensor = torch.Tensor
FEATURE = 'float_features'


def dims(config) -> List[int]:
  return [config['num_features']] + list(config['hidden_layer_dims'])


def draw_weights(config, seed: int, device) -> Dict[str, Tensor]:
  """Every matrix from one draw of normals on the device, each scaled to
  variance 1 / fan-in and clipped at two standard deviations; zero
  biases, identity batch norms, running statistics 0 and 1."""
  d = dims(config) + [config['output_units']]
  shapes = [(o, i) for i, o in zip(d[:-1], d[1:])]
  gen = torch.Generator(device).manual_seed(int(seed) % 2**63)
  flat = torch.randn(sum(o * i for o, i in shapes), generator=gen,
                     device=device)
  w, at = {}, 0
  names = [f'w{l}' for l in range(len(shapes) - 1)] + ['w_out']
  for name, (o, i) in zip(names, shapes):
    w[name] = (flat[at:at + o * i].reshape(o, i).clamp(-2.0, 2.0)
               / i ** 0.5).contiguous()
    at += o * i
  for l, o in enumerate(d[1:-1]):
    w[f'b{l}'] = torch.zeros(o, device=device)
    w[f'gamma{l}'] = torch.ones(o, device=device)
    w[f'beta{l}'] = torch.zeros(o, device=device)
    w[f'mean{l}'] = torch.zeros(o, device=device)
    w[f'var{l}'] = torch.ones(o, device=device)
  w['b_out'] = torch.zeros(config['output_units'], device=device)
  return w


def trainable(config) -> List[str]:
  n = len(config['hidden_layer_dims'])
  return ([f'{k}{l}' for l in range(n) for k in ('w', 'b', 'gamma', 'beta')]
          + ['w_out', 'b_out'])


def _port_names(config) -> Dict[str, str]:
  """The weight of each port parameter and buffer."""
  out = {}
  n = len(config['hidden_layer_dims'])
  for l in range(n):
    out[f'scorer.tower.dense.{l}.weight'] = f'w{l}'
    out[f'scorer.tower.dense.{l}.bias'] = f'b{l}'
    out[f'scorer.tower.bn.{l}.weight'] = f'gamma{l}'
    out[f'scorer.tower.bn.{l}.bias'] = f'beta{l}'
    out[f'scorer.tower.bn.{l}.running_mean'] = f'mean{l}'
    out[f'scorer.tower.bn.{l}.running_var'] = f'var{l}'
  out[f'scorer.tower.dense.{n}.weight'] = 'w_out'
  out[f'scorer.tower.dense.{n}.bias'] = 'b_out'
  return out


def build(config, weights: Dict[str, Tensor], device):
  """The program's model on ``device``, holding a copy of ``weights``."""
  from ranking_tpu_torch.models import scorers
  with torch.device('meta'):
    model = scorers.RankingModel(scorers.DNNScorer(
        config['hidden_layer_dims'], in_features=config['num_features'],
        output_units=config['output_units'],
        activation=config['activation'],
        use_batch_norm=config['use_batch_norm'],
        batch_norm_momentum=config['batch_norm_momentum'],
        dropout=config['dropout'],
        input_grad=config['input_gradient']), config['transform'])
  model = model.to_empty(device=device)
  tensors = dict(model.named_parameters())
  tensors.update(model.named_buffers())
  names = _port_names(config)
  with torch.no_grad():
    for port, t in tensors.items():
      if port in names:
        t.copy_(weights[names[port]])
      else:                      # num_batches_tracked
        t.zero_()
  return model


def leaf_params(config, model) -> Dict[str, Tensor]:
  """The program's parameter holding each trainable weight."""
  params = dict(model.named_parameters())
  return {leaf: params[port] for port, leaf in _port_names(config).items()
          if port in params}


# -- inputs ------------------------------------------------------------------


def make_lists(config, traffic, seed: int, num_lists: int):
  """``({feature: [Q, L, F]}, labels [Q, L])``, MSLR-shaped."""
  feats, labels = synth.mslr_lists(
      seed, num_lists, traffic['list_size'], config['num_features'],
      traffic['min_docs'], traffic['max_docs'])
  return {FEATURE: feats}, labels


def train_flops(config, examples, labels: np.ndarray) -> float:
  return work.dnn_train_flops(float((labels >= 0).sum()),
                              dims(config) + [config['output_units']])


def forward_flops(config, examples, labels: np.ndarray) -> float:
  return work.dnn_forward_flops(float((labels >= 0).sum()),
                                dims(config) + [config['output_units']])


def running_means(config, model) -> Dict[str, Tensor]:
  """The program's running mean of each batch-normalized layer."""
  buffers = dict(model.named_buffers())
  return {leaf: buffers[port] for port, leaf in _port_names(config).items()
          if leaf.startswith('mean')}


def reference_logits(config, w, examples: Dict[str, Tensor], labels: Tensor,
                     training: bool, stats=None) -> Tensor:
  """``stats``: as ``reference/dnn.py`` fills it, each layer's batch mean
  as the running mean takes it in (flax's momentum)."""
  batch = {} if stats is not None else None
  out = ref_dnn.forward(w, examples[FEATURE], labels >= 0, training,
                        eps=config['batch_norm_epsilon'], stats=batch)
  if stats is not None:
    rate = 1.0 - config['batch_norm_momentum']
    stats.update({k: rate * v for k, v in batch.items()})
  return out
