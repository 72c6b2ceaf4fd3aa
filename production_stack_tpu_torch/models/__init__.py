"""PyTorch model definitions (llama family)."""

from production_stack_tpu_torch.models.registry import (
    get_model,
    list_architectures,
)

__all__ = ["get_model", "list_architectures"]
