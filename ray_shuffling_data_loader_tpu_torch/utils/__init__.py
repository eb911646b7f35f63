from ray_shuffling_data_loader_tpu_torch.utils.device import resolve_device
from ray_shuffling_data_loader_tpu_torch.utils.prng import epoch_permutation

__all__ = ["epoch_permutation", "resolve_device"]
