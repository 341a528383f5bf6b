"""Plain PyTorch references of what the cells compute.

They follow the published descriptions (TF-Ranking's losses, metrics and
scorer; BERT's encoder; optax's optimizers) in float32 with TF32 off, and
import nothing of the program under test: every input, weight and state
they need is handed to them by the benchmark, which made it from the seed.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool):
  """Float32 products in full precision (``tf32=False``) or through TF32
  (the control's precision); the previous settings come back after."""
  matmul = torch.backends.cuda.matmul.allow_tf32
  cudnn = torch.backends.cudnn.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = tf32
  torch.backends.cudnn.allow_tf32 = tf32
  try:
    yield
  finally:
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn
