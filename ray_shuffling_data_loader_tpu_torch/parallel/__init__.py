from ray_shuffling_data_loader_tpu_torch.parallel.train import (
    bce_loss,
    make_optimizer,
    make_train_step,
)

__all__ = ["bce_loss", "make_optimizer", "make_train_step"]
