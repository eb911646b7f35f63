from ray_shuffling_data_loader_tpu_torch.parallel.mesh import DATA_AXIS, init_data_parallel
from ray_shuffling_data_loader_tpu_torch.parallel.train import (
    adasum_reduce,
    bce_loss,
    broadcast_parameters,
    make_optimizer,
    make_psum_train_step,
    make_train_step,
    ranks_with_batch,
)

__all__ = [
    "DATA_AXIS",
    "adasum_reduce",
    "bce_loss",
    "broadcast_parameters",
    "init_data_parallel",
    "make_optimizer",
    "make_psum_train_step",
    "make_train_step",
    "ranks_with_batch",
]
