"""The port's llama forward against the JAX package's, same weights.

The JAX ``init_params`` dict is carried across with
``params_from_numpy``; both forwards then run a prefill chunk, a T = 1
decode step and a mixed [R, W] block (a decode row, a prefill chunk
row and a pad row) over the same paged cache. JAX attends through its
XLA reference on the CPU, the port through its kernels' plain
versions.

Tolerance: f32 logits at atol = rtol = 1e-4. The attention sums run
in another order (page walk against one softmax), and each layer's
rounding carries into the next.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from production_stack_tpu.engine.config import (
    tiny_model_config as jax_tiny_model_config,
)
from production_stack_tpu.models import llama as jax_llama
from production_stack_tpu_torch.engine.config import tiny_model_config
from production_stack_tpu_torch.models import llama
from production_stack_tpu_torch.models.convert import params_from_numpy

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
PAGE_SIZE, NUM_PAGES, MAX_PAGES = 16, 16, 4


def _configs(variant):
    jax_cfg, port_cfg = jax_tiny_model_config("llama"), tiny_model_config()
    for cfg in (jax_cfg, port_cfg):
        cfg.attention_bias = variant == "bias"
        cfg.tie_word_embeddings = variant == "tied"
    return jax_cfg, port_cfg


def _params(jax_cfg, variant):
    params = {k: np.asarray(v) for k, v in
              jax_llama.init_params(jax_cfg, jax.random.PRNGKey(3)).items()}
    rng = np.random.RandomState(4)
    if variant == "bias":  # init makes zero biases: give them values
        for name in ("bq", "bk", "bv"):
            params[name] = (0.05 * rng.randn(*params[name].shape)
                            ).astype(np.float32)
    for name in ("attn_norm", "mlp_norm", "final_norm"):
        params[name] = (1 + 0.1 * rng.randn(*params[name].shape)
                        ).astype(np.float32)
    return params


def _steps():
    """(tokens, positions, page_table, kv_lens, valid) per step, with
    the engine's conventions: position 0 and valid False on pad slots,
    kv_lens counting this block's tokens, page 0 for a pad row."""
    rng = np.random.RandomState(5)
    tok = lambda *s: rng.randint(1, 500, size=s).astype(np.int32)  # noqa
    table = np.array([[1, 2, 0, 0], [3, 4, 0, 0], [0, 0, 0, 0]], np.int32)

    prefill_pos = np.zeros((2, 16), np.int32)
    prefill_valid = np.zeros((2, 16), bool)
    prefill_pos[0], prefill_valid[0] = np.arange(16), True
    prefill_pos[1, :10], prefill_valid[1, :10] = np.arange(10), True
    prefill = (tok(2, 16), prefill_pos, table[:2],
               np.array([16, 10], np.int32), prefill_valid)

    decode = (tok(2, 1), np.array([[16], [10]], np.int32), table[:2],
              np.array([17, 11], np.int32), np.ones((2, 1), bool))

    mixed_pos = np.zeros((3, 8), np.int32)
    mixed_valid = np.zeros((3, 8), bool)
    mixed_pos[0, 0], mixed_valid[0, 0] = 17, True  # decode row
    mixed_pos[1], mixed_valid[1] = np.arange(11, 19), True  # chunk row
    mixed = (tok(3, 8), mixed_pos, table, np.array([18, 19, 0], np.int32),
             mixed_valid)
    return {"prefill": prefill, "decode": decode, "mixed": mixed}


# The step kind the runner names for each step ("mixed" is a unified
# block, which goes through the ragged route).
KINDS = {"prefill": "prefill", "decode": "decode", "mixed": "ragged"}


@pytest.mark.parametrize("variant", ["plain", "bias", "tied"])
def test_forward_matches_jax(variant):
    jax_cfg, port_cfg = _configs(variant)
    np_params = _params(jax_cfg, variant)
    jax_params = {k: jnp.asarray(v) for k, v in np_params.items()}
    port_params = params_from_numpy(np_params, port_cfg, "cpu")
    layers, kv, d = (port_cfg.num_hidden_layers,
                     port_cfg.num_key_value_heads, port_cfg.head_dim)
    shape = (kv, NUM_PAGES, d, PAGE_SIZE)
    jax_k = jnp.zeros((layers,) + shape, jnp.float32)
    jax_v = jnp.zeros((layers,) + shape, jnp.float32)
    port_k = [torch.zeros(shape) for _ in range(layers)]
    port_v = [torch.zeros(shape) for _ in range(layers)]

    jax_forward = jax.jit(
        lambda *args: jax_llama.forward(args[0], jax_cfg, *args[1:]))
    for name, step in _steps().items():
        valid = step[4]
        expected, jax_k, jax_v = jax_forward(
            jax_params, *(jnp.asarray(x) for x in step), jax_k, jax_v)
        got = llama.forward(port_params, port_cfg,
                            *(torch.from_numpy(x) for x in step),
                            port_k, port_v, kind=KINDS[name])
        np.testing.assert_allclose(got.numpy()[valid],
                                   np.asarray(expected)[valid], **TOL,
                                   err_msg=name)
        # The in-place page writes match JAX's (page 0 is the trash page
        # pad slots write to, in an unspecified order).
        for layer in range(layers):
            np.testing.assert_allclose(
                port_k[layer].numpy()[:, 1:],
                np.asarray(jax_k[layer])[:, 1:], **TOL)
            np.testing.assert_allclose(
                port_v[layer].numpy()[:, 1:],
                np.asarray(jax_v[layer])[:, 1:], **TOL)


def test_select_gathers_the_sampled_slots():
    jax_cfg, port_cfg = _configs("plain")
    params = params_from_numpy(_params(jax_cfg, "plain"), port_cfg, "cpu")
    step = [torch.from_numpy(x) for x in _steps()["prefill"]]
    shape = (port_cfg.num_key_value_heads, NUM_PAGES, port_cfg.head_dim,
             PAGE_SIZE)

    def run(select=None):
        caches = ([torch.zeros(shape) for _ in range(2)],
                  [torch.zeros(shape) for _ in range(2)])
        return llama.forward(params, port_cfg, *step, *caches,
                             kind="prefill", select=select)

    full = run()
    select = torch.tensor([[15], [9]])
    torch.testing.assert_close(
        run(select), torch.take_along_dim(full, select[:, :, None], dim=1))


def test_rms_norm_upcasts_to_f32():
    x = torch.randn(3, 64, dtype=torch.bfloat16)
    w = torch.randn(64, dtype=torch.bfloat16)
    x32 = x.float()
    ref = (x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + 1e-5)
           * w.float()).to(torch.bfloat16)
    out = llama.rms_norm(x, w, 1e-5)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
