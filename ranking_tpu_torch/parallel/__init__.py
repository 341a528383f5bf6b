"""Process mesh, sharding rules, collectives and sharded embeddings."""

from ranking_tpu_torch.parallel import comm
from ranking_tpu_torch.parallel import embedding
from ranking_tpu_torch.parallel import list_sharding
from ranking_tpu_torch.parallel import mesh
from ranking_tpu_torch.parallel.embedding import (
    ShardedEmbeddingEncoder,
    sharded_pooled_lookup,
)
from ranking_tpu_torch.parallel.list_sharding import sharded_pairwise_loss
from ranking_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    DEFAULT_RULES,
    ENCODER_TP_RULES,
    MODEL_AXIS,
    Mesh,
    batch_sharding,
    init_distributed,
    local_batch_to_global,
    make_mesh,
    param_shardings,
    replicated,
    shard_batch,
    shard_module,
    shard_params,
)

__all__ = [
    'DATA_AXIS',
    'DEFAULT_RULES',
    'ENCODER_TP_RULES',
    'MODEL_AXIS',
    'Mesh',
    'ShardedEmbeddingEncoder',
    'batch_sharding',
    'comm',
    'embedding',
    'init_distributed',
    'list_sharding',
    'local_batch_to_global',
    'make_mesh',
    'mesh',
    'param_shardings',
    'replicated',
    'shard_batch',
    'shard_module',
    'shard_params',
    'sharded_pairwise_loss',
    'sharded_pooled_lookup',
]
