"""Faults planted in the program's timed path, to show that ``correct``
comes out false when the path is broken underneath. Each is a context
manager that patches the port while it is open. The benchmark's own runs
never open one: the tests and ``calibrate.py --fault`` do.
"""

from __future__ import annotations

import contextlib

import torch


def _tensors(tree):
  if isinstance(tree, torch.Tensor):
    yield tree
  elif isinstance(tree, dict):
    for v in tree.values():
      yield from _tensors(v)
  elif isinstance(tree, (list, tuple)):
    for v in tree:
      yield from _tensors(v)


def _state_tensors(state):
  """Every tensor of the train state that a step writes: the model's
  parameters and buffers and the optimizer's state and count."""
  opt = state.optimizer
  return (list(state.model.parameters()) + list(state.model.buffers())
          + list(_tensors(list(opt.state.values())))
          + list(_tensors(getattr(opt, 'count', None))))


@contextlib.contextmanager
def replay_leaves_state_unchanged():
  """Each CUDA graph replay of the train step (``GraphedSteps``) puts the
  train state back as it found it: the steps replayed from the graph
  return their state unchanged, the eager warm-up steps train."""
  from ranking_tpu_torch.train import steps
  call = steps.GraphedSteps.__call__
  replay = torch.cuda.CUDAGraph.replay

  def patched(self, state, stacked_batch, generator=None):
    tensors = _state_tensors(state)

    def unchanged(graph):
      saved = [t.detach().clone() for t in tensors]
      replay(graph)
      with torch.no_grad():
        for t, s in zip(tensors, saved):
          t.copy_(s)

    torch.cuda.CUDAGraph.replay = unchanged
    try:
      return call(self, state, stacked_batch, generator)
    finally:
      torch.cuda.CUDAGraph.replay = replay

  steps.GraphedSteps.__call__ = patched
  try:
    yield
  finally:
    steps.GraphedSteps.__call__ = call


PROGRAM_FAULTS = {'replay_unchanged': replay_leaves_state_unchanged}
