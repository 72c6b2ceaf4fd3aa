"""Checkpoint loading in the port against the JAX package's.

Each of the five tiny checkpoints that ``transformers`` writes for the
JAX package's own parity test (``tests/test_model_parity.py``: llama,
opt, gpt2, qwen2, mixtral) is loaded through both ``load_weights``:

- the tensors are equal after layout (the JAX dict carried across with
  ``params_from_numpy`` against the port's loader; f32, exact);
- the two ``LLMEngine``s' greedy streams are byte-identical, 12 tokens
  as there (and equal to HF's own greedy continuation);
- a ``pytorch_model.bin`` directory gives the same weights;
- ``from_hf_config`` equals JAX's for each saved ``config.json``.

Also: the port's safetensors reader round-trips F32, F16 and BF16 files
written by the ``safetensors`` package and by ``chip_smoke.py``'s own
writer; the tie rule; a checkpoint missing a leaf is refused; and no
port module imports ``safetensors``, nor ``transformers`` outside a
function.
"""

import ast
import dataclasses
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from production_stack_tpu.engine.config import (
    CacheConfig as JaxCacheConfig,
    EngineConfig as JaxEngineConfig,
    SchedulerConfig as JaxSchedulerConfig,
)
from production_stack_tpu.engine.engine import LLMEngine as JaxLLMEngine
from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu.engine import weights as jax_weights
from production_stack_tpu_torch.engine import weights
from production_stack_tpu_torch.engine.config import (
    CacheConfig,
    EngineConfig,
    ModelConfig,
    SchedulerConfig,
)
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.safetensors_io import (
    read_safetensors,
)
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.models.convert import params_from_numpy

from tests import test_model_parity as parity

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SAVERS = {"llama": parity._save_tiny_llama, "opt": parity._save_tiny_opt,
          "gpt2": parity._save_tiny_gpt2, "qwen2": parity._save_tiny_qwen2,
          "mixtral": parity._save_tiny_mixtral}
PROMPT = [3, 11, 25, 99, 7, 42, 58, 13, 77, 21, 5, 64]

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)


def _configs(path):
    jax_cfg = jax_weights.load_model_config(path)
    port_cfg = weights.load_model_config(path)
    jax_cfg.dtype = port_cfg.dtype = "float32"
    return jax_cfg, port_cfg


def _state(module):
    return {k: v.detach().float() for k, v in module.state_dict().items()}


@pytest.mark.parametrize("arch", sorted(SAVERS))
def test_loaded_tensors_equal_the_jax_loaders(tmp_path, arch):
    path, _ = SAVERS[arch](tmp_path)
    jax_cfg, port_cfg = _configs(path)
    jax_params = jax_weights.load_weights(path, jax_cfg)
    ours = weights.load_weights(path, port_cfg, device="cpu")
    assert port_cfg.tie_word_embeddings == jax_cfg.tie_word_embeddings
    theirs = params_from_numpy({k: np.asarray(v)
                                for k, v in jax_params.items()},
                               port_cfg, "cpu")
    a, b = _state(ours), _state(theirs)
    assert sorted(a) == sorted(b)
    for name in a:
        assert torch.equal(a[name], b[name]), name


def _port_engine(path, params=None):
    _, cfg = _configs(path)
    if params is None:
        params = weights.load_weights(path, cfg, device="cpu")
    return LLMEngine(EngineConfig(
        model=cfg, cache=CacheConfig(page_size=8, num_pages=128),
        scheduler=SchedulerConfig(max_num_seqs=4, max_model_len=256,
                                  prefill_chunk_size=16)),
        params=params, device="cpu")


@pytest.mark.parametrize("arch", sorted(SAVERS))
def test_greedy_streams_match_the_jax_engine(tmp_path, arch):
    path, hf_model = SAVERS[arch](tmp_path)
    jax_cfg, _ = _configs(path)
    jax_engine = JaxLLMEngine(JaxEngineConfig(
        model=jax_cfg, cache=JaxCacheConfig(page_size=8, num_pages=128),
        scheduler=JaxSchedulerConfig(max_num_seqs=4, max_model_len=256,
                                     prefill_chunk_size=16)),
        params=jax_weights.load_weights(path, jax_cfg))
    theirs = jax_engine.generate(PROMPT, JaxSamplingParams(
        max_tokens=12, temperature=0.0, ignore_eos=True))
    ours = _port_engine(path).generate(PROMPT, SamplingParams(
        max_tokens=12, temperature=0.0, ignore_eos=True))
    assert ours.output_token_ids == theirs.output_token_ids
    assert ours.output_token_ids == parity._hf_greedy(hf_model, PROMPT, 12)


@pytest.mark.parametrize("arch", sorted(SAVERS))
def test_pytorch_bin_gives_the_same_weights(tmp_path, arch):
    path, hf_model = SAVERS[arch](tmp_path)
    bin_dir = str(tmp_path / "bin")
    hf_model.save_pretrained(bin_dir, safe_serialization=False)
    assert weights.checkpoint_files(bin_dir)[0] == "bin"
    _, cfg = _configs(path)
    _, bin_cfg = _configs(bin_dir)
    a = _state(weights.load_weights(path, cfg, device="cpu"))
    b = _state(weights.load_weights(bin_dir, bin_cfg, device="cpu"))
    assert sorted(a) == sorted(b)
    for name in a:
        assert torch.equal(a[name], b[name]), name


@pytest.mark.parametrize("arch", sorted(SAVERS))
def test_from_hf_config_is_the_jax_mapping(tmp_path, arch):
    from production_stack_tpu.engine.config import (
        ModelConfig as JaxModelConfig,
    )
    path, _ = SAVERS[arch](tmp_path)
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    ours = dataclasses.asdict(ModelConfig.from_hf_config(hf, "m"))
    theirs = dataclasses.asdict(JaxModelConfig.from_hf_config(hf, "m"))
    assert ours == {k: theirs[k] for k in ours}
    assert ours["architecture"] == arch


def test_a_checkpoint_without_lm_head_ties_it(tmp_path):
    """The JAX rule: a llama checkpoint with no ``lm_head.weight`` ties
    the head to the embeddings, in both loaders."""
    path, _ = parity._save_tiny_llama(tmp_path)
    st = os.path.join(path, "model.safetensors")
    from safetensors.torch import load_file, save_file
    tensors = load_file(st)
    tensors.pop("lm_head.weight")
    save_file(tensors, st, metadata={"format": "pt"})
    jax_cfg, port_cfg = _configs(path)
    assert not port_cfg.tie_word_embeddings
    params = weights.load_weights(path, port_cfg, device="cpu")
    jax_weights.load_weights(path, jax_cfg)
    assert port_cfg.tie_word_embeddings and jax_cfg.tie_word_embeddings
    assert params.lm_head is None


def test_a_missing_leaf_is_refused(tmp_path):
    path, _ = parity._save_tiny_opt(tmp_path)
    st = os.path.join(path, "model.safetensors")
    from safetensors.torch import load_file, save_file
    tensors = load_file(st)
    tensors.pop("model.decoder.layers.1.fc2.bias")
    save_file(tensors, st, metadata={"format": "pt"})
    _, cfg = _configs(path)
    with pytest.raises(ValueError, match="layers.1.fc2.bias"):
        weights.load_weights(path, cfg, device="cpu")


def test_a_directory_without_weights_is_refused(tmp_path):
    with pytest.raises(FileNotFoundError, match="No safetensors"):
        weights.checkpoint_files(str(tmp_path))


DTYPES = [torch.float32, torch.float16, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
def test_reader_round_trips_the_packages_files(tmp_path, dtype):
    from safetensors.torch import load_file, save_file
    gen = torch.Generator().manual_seed(4)
    tensors = {"a.weight": torch.randn((3, 5), generator=gen).to(dtype),
               "b": torch.randn((7,), generator=gen).to(dtype),
               "scalar": torch.randn((), generator=gen).to(dtype),
               "empty": torch.zeros((0, 4), dtype=dtype)}
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got, want = read_safetensors(path), load_file(path)
    assert sorted(got) == sorted(want)
    for name, t in want.items():
        assert got[name].dtype == dtype and got[name].shape == t.shape
        assert torch.equal(got[name], t)


@pytest.mark.parametrize("dtype", DTYPES)
def test_reader_round_trips_chip_smokes_writer(tmp_path, dtype):
    """``chip_smoke.py`` writes its checkpoints with its own writer (the
    card's machine has no safetensors package): the port's reader and
    the package read its files back bit for bit."""
    from safetensors.torch import load_file
    gen = torch.Generator().manual_seed(5)
    tensors = {"x.weight": torch.randn((6, 4), generator=gen).to(dtype),
               "y": torch.randn((9,), generator=gen).to(dtype)}
    path = str(tmp_path / "w.safetensors")
    chip_smoke.write_safetensors(path, [(n, t.shape, t.dtype, lambda t=t: t)
                                        for n, t in tensors.items()])
    for got in (read_safetensors(path), load_file(path)):
        assert sorted(got) == sorted(tensors)
        for name, t in tensors.items():
            assert got[name].dtype == dtype
            assert torch.equal(got[name], t)


def _imports(tree):
    """(module, depth) of every import: depth 0 at module level, more
    inside a function or class."""
    out = []

    def visit(node, depth):
        for child in ast.iter_child_nodes(node):
            d = depth + isinstance(child, (ast.FunctionDef,
                                           ast.AsyncFunctionDef,
                                           ast.ClassDef))
            if isinstance(child, ast.Import):
                out.extend((a.name, d) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                out.append((child.module or "", d))
            visit(child, d)
    visit(tree, 0)
    return out


def test_the_port_imports_no_safetensors_and_transformers_lazily():
    files = sorted((ROOT / "production_stack_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    lazy = []
    for path in files:
        for module, depth in _imports(ast.parse(path.read_text())):
            top = module.split(".")[0]
            assert top != "safetensors", path
            if top in ("transformers", "tokenizers"):
                assert depth > 0, path
                lazy.append(path.name)
    assert lazy == ["tokenizer.py"]
