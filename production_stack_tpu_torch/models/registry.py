"""Architecture registry mapping config.architecture -> (init, forward),
the JAX package's ``models/registry.py`` in the port, plus each
family's params module (what the int8 init and the checkpoint loader
build) and its module (``get_family``: the stage functions)."""

import importlib
from typing import Callable, Tuple

from production_stack_tpu_torch.engine.config import ModelConfig

# architecture -> (module of models/, its params class)
_FAMILIES = {
    "llama": ("llama", "LlamaParams"),
    "mistral": ("llama", "LlamaParams"),
    "qwen2": ("llama", "LlamaParams"),
    "opt": ("opt", "OPTParams"),
    "gpt2": ("gpt2", "GPT2Params"),
    "mixtral": ("mixtral", "MixtralParams"),
}


def _family(config: ModelConfig):
    arch = config.architecture
    if arch not in _FAMILIES:
        raise ValueError(f"Unknown architecture: {arch}")
    name, params = _FAMILIES[arch]
    module = importlib.import_module(
        f"production_stack_tpu_torch.models.{name}")
    return module, getattr(module, params)


def get_model(config: ModelConfig) -> Tuple[Callable, Callable]:
    """Returns (init_params, forward) for the configured architecture."""
    module, _ = _family(config)
    return module.init_params, module.forward


def get_family(config: ModelConfig):
    """The architecture's module of models/, whose stage functions
    (``embed``, ``decoder_layers``, ``head``; a layer's ``attn_norm``,
    ``mlp_norm``, ``mlp``) the pipeline and
    context-parallel forwards compose (parallel/pipeline_serving.py,
    context_serving.py)."""
    return _family(config)[0]


def params_class(config: ModelConfig) -> type:
    """The ``nn.Module`` class of the architecture's weights, built as
    ``cls(config, device)``."""
    return _family(config)[1]


def list_architectures():
    return ["llama", "mistral", "qwen2", "opt", "gpt2", "mixtral"]
