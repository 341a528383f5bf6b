"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = 'cuda') -> torch.device:
  """``torch.device(device)``, refusing a CUDA device that is not there.

  Entry points default to ``'cuda'``; without CUDA they raise instead of
  carrying on quietly on the CPU. Pass ``device='cpu'`` to run there.
  """
  device = torch.device(device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(
        "CUDA is not available; pass device='cpu' to run on the CPU")
  return device
