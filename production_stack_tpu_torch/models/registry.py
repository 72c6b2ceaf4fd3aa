"""Architecture registry mapping config.architecture -> (init, forward)."""

from typing import Callable, Tuple

from production_stack_tpu_torch.engine.config import ModelConfig


def get_model(config: ModelConfig) -> Tuple[Callable, Callable]:
    """Returns (init_params, forward) for the configured architecture."""
    arch = config.architecture
    if arch in ("llama", "mistral", "qwen2"):
        from production_stack_tpu_torch.models import llama
        return llama.init_params, llama.forward
    raise NotImplementedError(
        f"architecture {arch!r} is not ported (the port serves "
        f"{', '.join(list_architectures())})")


def list_architectures():
    return ["llama", "mistral", "qwen2"]
