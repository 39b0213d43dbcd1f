"""The port's umT5 encoder against ``moviigen_tpu.models.t5.encode``, fp32,
at 5e-5 (the tolerance of tests/test_t5_parity.py), with the JAX
parameters carried across by ``convert``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moviigen_tpu.configs import T5Config as JaxT5Config
from moviigen_tpu.models import t5 as jt5
from moviigen_tpu.ops.quantization import quantize_t5_params
from moviigen_tpu_torch.configs import T5Config
from moviigen_tpu_torch.convert import load_t5_params
from moviigen_tpu_torch.models.t5 import T5Encoder, relative_position_buckets

KW = dict(vocab_size=96, dim=32, dim_attn=32, dim_ffn=64, num_heads=4,
          num_layers=3, num_buckets=32, shared_pos=False)


@pytest.fixture(scope="module")
def pair():
    params = jax.tree_util.tree_map(np.asarray, jt5.init_params(
        jax.random.PRNGKey(0), JaxT5Config(**KW), dtype=jnp.float32))
    model = load_t5_params(T5Encoder(T5Config(**KW), dtype=torch.float32),
                           params)
    return params, model


@pytest.mark.parametrize("masked", [True, False])
def test_encode(pair, masked):
    params, model = pair
    rng = np.random.default_rng(0)
    ids = rng.integers(0, KW["vocab_size"], size=(2, 20))
    mask = np.ones((2, 20), np.int64)
    mask[0, 13:] = 0
    mask[1, 7:] = 0
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    want = np.asarray(jt5.encode(params, jnp.asarray(ids), jm,
                                 JaxT5Config(**KW)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), tm).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)


def test_buckets_match():
    for lq, lk, bidir in ((20, 20, True), (7, 33, True), (9, 9, False)):
        np.testing.assert_array_equal(
            relative_position_buckets(lq, lk, bidirectional=bidir),
            jt5.relative_position_buckets(lq, lk, bidirectional=bidir))


@pytest.mark.parametrize("dtype,tol", [("float32", 5e-5), ("bfloat16", None)])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_encode(bits, dtype, tol):
    """The weight-only quantized encoder (int8 / int4 block linears, int8
    per-row token table) from the JAX quantized tree. fp32: the
    dequantized weights are equal, so the unquantized tolerance holds.
    bf16: activations and dequantized weights round to 8 bits at other
    places in the two frameworks over 3 blocks; 3e-2 of the output's norm
    bounds it (a wrong nibble order or scale axis is off by O(1))."""
    params = jax.tree_util.tree_map(np.asarray, jt5.init_params(
        jax.random.PRNGKey(1), JaxT5Config(**KW), dtype=getattr(jnp, dtype)))
    tree = quantize_t5_params(params, bits=bits)
    assert "q8" in tree["token_embedding"]
    model = load_t5_params(
        T5Encoder(T5Config(**KW), dtype=getattr(torch, dtype),
                  quant_bits=bits), tree)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, KW["vocab_size"], size=(2, 20))
    mask = np.ones((2, 20), np.int64)
    mask[1, 7:] = 0
    want = np.asarray(jt5.encode(tree, jnp.asarray(ids), jnp.asarray(mask),
                                 JaxT5Config(**KW)).astype(jnp.float32))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    if tol is not None:
        np.testing.assert_allclose(got, want, atol=tol, rtol=1e-4)
    else:
        assert np.linalg.norm(got - want) < 3e-2 * np.linalg.norm(want)
