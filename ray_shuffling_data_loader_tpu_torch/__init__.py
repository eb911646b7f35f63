"""PyTorch/CUDA port of the shuffling data loader.

Parquet -> per-epoch map/reduce shuffle -> exact-size batches staged to the
GPU -> the train step of the DLRM, whose dot interaction is a hand-written
CUDA kernel, or of the TabTransformer; and the causal LM. Both transformers
attend through hand-written CUDA flash attention kernels, forward and
backward. Entry points run on CUDA unless the caller passes
``device="cpu"``. The package is independent of the JAX package it was
ported from, which stays the reference its tests compare against.
"""

from ray_shuffling_data_loader_tpu_torch import runtime
from ray_shuffling_data_loader_tpu_torch.convert import (
    dlrm_state_dict_from_jax,
    lm_state_dict_from_jax,
    transformer_state_dict_from_jax,
)
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
    CausalLM,
    TabTransformer,
    TabularDLRM,
    dlrm_for_data_spec,
    example_features,
    next_token_loss,
    synthetic_tokens,
    transformer_for_data_spec,
)
from ray_shuffling_data_loader_tpu_torch.ops import (
    attention_reference,
    dot_interaction,
    dot_interaction_reference,
    flash_attention,
    flash_attention_qkv,
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
    "CausalLM",
    "ColumnBatch",
    "DATA_SPEC",
    "DeviceShufflingDataset",
    "HostToDeviceStats",
    "KEY_COLUMN",
    "LABEL_COLUMN",
    "ShufflingDataset",
    "TabTransformer",
    "TabularDLRM",
    "TorchBatchSpec",
    "attention_reference",
    "bce_loss",
    "dlrm_for_data_spec",
    "dlrm_state_dict_from_jax",
    "dot_interaction",
    "dot_interaction_reference",
    "example_features",
    "flash_attention",
    "flash_attention_qkv",
    "generate_data",
    "interaction_kernel",
    "lm_state_dict_from_jax",
    "make_optimizer",
    "make_train_step",
    "next_token_loss",
    "resolve_device",
    "runtime",
    "synthetic_tokens",
    "transformer_for_data_spec",
    "transformer_state_dict_from_jax",
]
