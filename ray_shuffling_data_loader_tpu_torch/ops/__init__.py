from ray_shuffling_data_loader_tpu_torch.ops.flash_attention import (
    NEG_INF,
    FlashAttention,
    attention_reference,
    flash_attention,
    flash_attention_qkv,
    flash_backward_reference,
    flash_bwd_dkv_kernel,
    flash_bwd_dq_kernel,
    flash_forward_reference,
    flash_fwd_kernel,
    row_dot,
)
from ray_shuffling_data_loader_tpu_torch.ops.interaction import (
    dot_interaction,
    dot_interaction_reference,
    interaction_kernel,
    num_pairs,
)

__all__ = [
    "FlashAttention",
    "NEG_INF",
    "attention_reference",
    "dot_interaction",
    "dot_interaction_reference",
    "flash_attention",
    "flash_attention_qkv",
    "flash_backward_reference",
    "flash_bwd_dkv_kernel",
    "flash_bwd_dq_kernel",
    "flash_forward_reference",
    "flash_fwd_kernel",
    "interaction_kernel",
    "num_pairs",
    "row_dot",
]
