from ray_shuffling_data_loader_tpu_torch.ops.interaction import (
    dot_interaction,
    dot_interaction_reference,
    interaction_kernel,
    num_pairs,
)

__all__ = [
    "dot_interaction",
    "dot_interaction_reference",
    "interaction_kernel",
    "num_pairs",
]
