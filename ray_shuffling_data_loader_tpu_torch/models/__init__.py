from ray_shuffling_data_loader_tpu_torch.models.dlrm import (
    TabularDLRM,
    dlrm_for_data_spec,
    example_features,
)
from ray_shuffling_data_loader_tpu_torch.models.lm import (
    CausalLM,
    next_token_loss,
    synthetic_tokens,
)
from ray_shuffling_data_loader_tpu_torch.models.transformer import (
    EncoderBlock,
    TabTransformer,
    transformer_for_data_spec,
)

__all__ = [
    "CausalLM",
    "EncoderBlock",
    "TabTransformer",
    "TabularDLRM",
    "dlrm_for_data_spec",
    "example_features",
    "next_token_loss",
    "synthetic_tokens",
    "transformer_for_data_spec",
]
