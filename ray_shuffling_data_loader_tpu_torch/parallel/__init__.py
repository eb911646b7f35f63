from ray_shuffling_data_loader_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    DEFAULT_VOCAB_SHARD_THRESHOLD,
    MODEL_AXIS,
    Mesh,
    SequenceMesh,
    init_data_parallel,
    make_mesh,
    make_sp_mesh,
    param_spec,
)
from ray_shuffling_data_loader_tpu_torch.parallel.sharded_embedding import ShardedEmbedding
from ray_shuffling_data_loader_tpu_torch.parallel.train import (
    adasum_reduce,
    bce_loss,
    broadcast_parameters,
    make_optimizer,
    make_psum_train_step,
    make_train_step,
    ranks_with_batch,
    shard_model,
)

__all__ = [
    "DATA_AXIS",
    "DEFAULT_VOCAB_SHARD_THRESHOLD",
    "MODEL_AXIS",
    "Mesh",
    "SequenceMesh",
    "ShardedEmbedding",
    "adasum_reduce",
    "bce_loss",
    "broadcast_parameters",
    "init_data_parallel",
    "make_mesh",
    "make_optimizer",
    "make_psum_train_step",
    "make_sp_mesh",
    "make_train_step",
    "param_spec",
    "ranks_with_batch",
    "shard_model",
]
