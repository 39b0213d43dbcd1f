"""The port's DiT forward against ``moviigen_tpu.models.wan_model.forward``
on t2v-tiny, with the JAX parameters carried across by ``convert``.

The JAX head is zero-initialised, which would make every prediction 0;
the tests give it random weights in the JAX tree before carrying it
across."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moviigen_tpu.configs import WAN_CONFIGS as JAX_CONFIGS
from moviigen_tpu.models import wan_model as jwan
from moviigen_tpu.ops.rope import rope_3d_freqs as jax_rope
from moviigen_tpu_torch.configs import WAN_CONFIGS
from moviigen_tpu_torch.convert import load_wan_params
from moviigen_tpu_torch.models.wan_model import WanModel
from moviigen_tpu_torch.ops.rope import rope_3d_freqs

JCFG = JAX_CONFIGS["t2v-tiny"].model
CFG = WAN_CONFIGS["t2v-tiny"].model


def jax_params_with_head(dtype, seed=0):
    """JAX init_params with a random non-zero head, as numpy."""
    params = jax.tree_util.tree_map(
        np.asarray, jwan.init_params(jax.random.PRNGKey(seed), JCFG, dtype))
    head = params["head"]["head"]
    rng = np.random.default_rng(seed + 100)
    head["kernel"] = (rng.standard_normal(head["kernel"].shape) * 0.1) \
        .astype(head["kernel"].dtype)
    head["bias"] = (rng.standard_normal(head["bias"].shape) * 0.1) \
        .astype(head["bias"].dtype)
    return params


@pytest.fixture(scope="module")
def fp32_pair():
    params = jax_params_with_head(jnp.float32)
    model = load_wan_params(WanModel(CFG, dtype=torch.float32), params)
    return params, model


def _inputs(fhw, seed):
    f, h, w = fhw
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, CFG.in_dim, f, h, w)).astype(np.float32)
    ctx = rng.standard_normal((2, CFG.text_len, CFG.text_dim)) \
        .astype(np.float32)
    ctx[1, 9:] = 0.0  # a zero-padded prompt
    t = np.array([500.0, 37.0], np.float32)
    return x, t, ctx


def _run_both(params, model, fhw, seq_len, cd, rdt, seed=0):
    x, t, ctx = _inputs(fhw, seed)
    grid = (fhw[0], fhw[1] // 2, fhw[2] // 2)
    want = np.asarray(jwan.forward(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), JCFG,
        jax_rope(grid, JCFG.head_dim), seq_len=seq_len,
        compute_dtype=getattr(jnp, cd), attn_backend="xla",
        residual_dtype=getattr(jnp, rdt)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t),
                    torch.from_numpy(ctx), rope_3d_freqs(grid, CFG.head_dim),
                    seq_len=seq_len, compute_dtype=getattr(torch, cd),
                    attn_backend="plain",
                    residual_dtype=getattr(torch, rdt)).numpy()
    return got, want


@pytest.mark.parametrize("fhw,pad", [((3, 8, 8), 0), ((2, 4, 6), 7)])
def test_forward_fp32(fp32_pair, fhw, pad):
    """fp32 params and compute, at tests/test_model_parity.py's 5e-4;
    ``pad`` > 0 pads the sequence (masked keys via k_lens)."""
    params, model = fp32_pair
    seq_len = fhw[0] * fhw[1] * fhw[2] // 4 + pad
    got, want = _run_both(params, model, fhw, seq_len, "float32", "float32")
    assert np.abs(want).max() > 1e-2  # the head is live
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)


def test_forward_bf16_residual(fp32_pair):
    """bf16 residual stream, fp32 compute: both sides round the residual
    to bf16 after every add (8 mantissa bits), and roundings that land on
    either side of a tie drift apart over the blocks; 2e-2 of the output
    scale bounds a few bf16 steps of the residual carried to the head."""
    params, model = fp32_pair
    got, want = _run_both(params, model, (2, 4, 4), 8, "float32", "bfloat16",
                          seed=3)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-2 * scale


def test_memory_knobs_raise():
    model = WanModel(CFG.replace(ffn_chunk=64), dtype=torch.float32)
    x, t, ctx = (torch.from_numpy(a) for a in _inputs((1, 4, 4), 0))
    with pytest.raises(NotImplementedError, match="ffn_chunk"):
        model(x, t, ctx, rope_3d_freqs((1, 2, 2), CFG.head_dim))
