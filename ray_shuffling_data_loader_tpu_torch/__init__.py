"""PyTorch/CUDA port of the shuffling data loader.

Parquet -> per-epoch map/reduce shuffle in spawned worker processes over a
shared-memory store -> a named cross-process batch queue -> exact-size
batches staged to the GPU of each trainer rank -> the train step of the
DLRM, whose dot interaction is a hand-written CUDA kernel, or of the
TabTransformer, alone or data-parallel over ranks; and the causal LM.
Both transformers attend through hand-written CUDA flash attention
kernels, forward and backward. A dataset that fits the card can instead
stay in its memory and shuffle there every epoch
(:class:`~.resident.DeviceResidentShufflingDataset`), with an epoch of
DLRM steps replayed from one CUDA graph (:func:`~.resident.make_fused_epoch`). Entry points run on CUDA unless the caller
passes ``device="cpu"``. The package is independent of the JAX package it
was ported from, which stays the reference its tests compare against.

Names resolve on first use (PEP 562): the spawned shuffle workers import
this package for :mod:`.runtime` and :mod:`.shuffle` and never load
``torch``.
"""

import importlib

__version__ = "0.1.0"

_EXPORTS = {
    "runtime": None,
    "telemetry": None,  # ``telemetry.audit``: the exactly-once digests (RSDL_AUDIT)
    "BatchCursor": "checkpoint",
    "CheckpointManager": "checkpoint",
    "adam_state_dict_from_jax": "convert",
    "dlrm_state_dict_from_jax": "convert",
    "gather_state_dict": "convert",
    "lm_state_dict_from_jax": "convert",
    "transformer_state_dict_from_jax": "convert",
    "DATA_SPEC": "data_generation",
    "KEY_COLUMN": "data_generation",
    "LABEL_COLUMN": "data_generation",
    "cached_generate_data": "data_generation",
    "generate_data": "data_generation",
    "BatchQueue": "batch_queue",
    "ProducerDiedError": "batch_queue",
    "CarryRebatcher": "dataset",
    "ShufflingDataset": "dataset",
    "DeviceResidentShufflingDataset": "resident",
    "DeviceShufflingDataset": "device_dataset",
    "HostToDeviceStats": "device_dataset",
    "TorchBatchSpec": "device_dataset",
    "CausalLM": "models",
    "TabTransformer": "models",
    "TabularDLRM": "models",
    "dlrm_for_data_spec": "models",
    "example_features": "models",
    "next_token_loss": "models",
    "synthetic_tokens": "models",
    "transformer_for_data_spec": "models",
    "attention_reference": "ops",
    "blockwise_attention": "ops",
    "dot_interaction": "ops",
    "dot_interaction_reference": "ops",
    "flash_attention": "ops",
    "flash_attention_qkv": "ops",
    "interaction_kernel": "ops",
    "make_ring_attention": "ops",
    "make_ulysses_attention": "ops",
    "ring_attention": "ops",
    "DATA_AXIS": "parallel",
    "adasum_reduce": "parallel",
    "bce_loss": "parallel",
    "init_data_parallel": "parallel",
    "make_optimizer": "parallel",
    "make_psum_train_step": "parallel",
    "make_mesh": "parallel",
    "make_sp_mesh": "parallel",
    "make_train_step": "parallel",
    "shard_model": "parallel",
    "ColumnBatch": "runtime",
    "TorchShufflingDataset": "torch_dataset",
    "TrialStatsCollector": "stats",
    "epoch_permutation": "utils",
    "fits_device": "resident",
    "make_fused_epoch": "resident",
    "process_stats": "stats",
    "resolve_device": "utils",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = _EXPORTS[name]
    if module is None:
        # importlib, not ``from . import``: that form would re-enter this
        # hook while the attribute is still unbound.
        return importlib.import_module(f"{__name__}.{name}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
