"""The batch data model and host-side batch layout helpers."""

from ranking_tpu_torch.data import bert

__all__ = ['bert']
