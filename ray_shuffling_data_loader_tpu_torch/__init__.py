"""PyTorch/CUDA port of the shuffling data loader.

Parquet -> per-epoch map/reduce shuffle -> exact-size batches staged to the
GPU -> the DLRM train step, whose dot interaction is a hand-written CUDA
kernel. Entry points run on CUDA unless the caller passes
``device="cpu"``. The package is independent of the JAX package it was
ported from, which stays the reference its tests compare against.
"""

from ray_shuffling_data_loader_tpu_torch import runtime
from ray_shuffling_data_loader_tpu_torch.convert import dlrm_state_dict_from_jax
from ray_shuffling_data_loader_tpu_torch.data_generation import (
    DATA_SPEC,
    KEY_COLUMN,
    LABEL_COLUMN,
    generate_data,
)
from ray_shuffling_data_loader_tpu_torch.dataset import CarryRebatcher, ShufflingDataset
from ray_shuffling_data_loader_tpu_torch.device_dataset import (
    DeviceShufflingDataset,
    HostToDeviceStats,
    TorchBatchSpec,
)
from ray_shuffling_data_loader_tpu_torch.models import (
    TabularDLRM,
    dlrm_for_data_spec,
    example_features,
)
from ray_shuffling_data_loader_tpu_torch.ops import (
    dot_interaction,
    dot_interaction_reference,
    interaction_kernel,
)
from ray_shuffling_data_loader_tpu_torch.parallel import (
    bce_loss,
    make_optimizer,
    make_train_step,
)
from ray_shuffling_data_loader_tpu_torch.runtime import ColumnBatch
from ray_shuffling_data_loader_tpu_torch.utils import resolve_device

__all__ = [
    "CarryRebatcher",
    "ColumnBatch",
    "DATA_SPEC",
    "DeviceShufflingDataset",
    "HostToDeviceStats",
    "KEY_COLUMN",
    "LABEL_COLUMN",
    "ShufflingDataset",
    "TabularDLRM",
    "TorchBatchSpec",
    "bce_loss",
    "dlrm_for_data_spec",
    "dlrm_state_dict_from_jax",
    "dot_interaction",
    "dot_interaction_reference",
    "example_features",
    "generate_data",
    "interaction_kernel",
    "make_optimizer",
    "make_train_step",
    "resolve_device",
    "runtime",
]
