from ray_shuffling_data_loader_tpu_torch.models.dlrm import (
    TabularDLRM,
    dlrm_for_data_spec,
    example_features,
)

__all__ = ["TabularDLRM", "dlrm_for_data_spec", "example_features"]
