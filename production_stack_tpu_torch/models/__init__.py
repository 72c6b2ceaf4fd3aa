"""PyTorch model definitions: the llama family (llama, mistral,
qwen2), OPT, GPT-2 and Mixtral."""

from production_stack_tpu_torch.models.registry import (
    get_model,
    list_architectures,
)

__all__ = ["get_model", "list_architectures"]
