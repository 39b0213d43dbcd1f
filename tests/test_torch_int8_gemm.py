"""The port's W8A8 GEMM (plain version; the CUDA kernel runs only on the
card, ``tests/test_torch_kernels_gpu.py``) against
``moviigen_tpu.ops.int8_gemm``, run as ``tests/test_int8_gemm.py`` runs
it: the Pallas kernel in interpret mode at tileable shapes, its exact XLA
branch at (7, 48, 20).

The int32 sum is exact on both sides. In fp32 the epilogue is three
roundings that XLA may fuse differently (an fma for ``· sw + bias``), so
fp32 outputs are held to that file's rtol 1e-6 / atol 1e-5; bf16 outputs
to one bf16 step (2^-8 relative) of the fp32 result, where such a 1-ulp
fp32 difference can flip a rounding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moviigen_tpu.ops import int8_gemm as jig
from moviigen_tpu.ops.quantization import quantize_linear as jax_quantize
from moviigen_tpu_torch.ops import int8_gemm as tig
from moviigen_tpu_torch.ops.quantization import QuantLinear

SHAPES = [(256, 512, 640), (96, 256, 128), (7, 48, 20)]


def _operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (m, k), dtype=np.int8)
    wq = rng.integers(-127, 128, (k, n), dtype=np.int8)       # JAX layout
    sx = rng.uniform(1e-3, 2e-2, (m, 1)).astype(np.float32)
    sw = rng.uniform(1e-3, 2e-2, (n,)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    return xq, wq, sx, sw, bias


def _jax(xq, wq, sx, sw, bias, out_dtype):
    out = jig.int8_gemm_fused(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(sx), jnp.asarray(sw),
        None if bias is None else jnp.asarray(bias), out_dtype=out_dtype)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("fn", ["int8_gemm_plain", "int8_gemm_fused"])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_gemm_fp32_matches_jax(m, k, n, with_bias, fn):
    xq, wq, sx, sw, bias = _operands(m, k, n)
    bias = bias if with_bias else None
    want = _jax(xq, wq, sx, sw, bias, jnp.float32)
    got = getattr(tig, fn)(
        torch.from_numpy(xq), torch.from_numpy(wq.T.copy()),
        torch.from_numpy(sx), torch.from_numpy(sw),
        None if bias is None else torch.from_numpy(bias),
        out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_gemm_bf16_matches_jax(m, k, n, with_bias):
    xq, wq, sx, sw, bias = _operands(m, k, n, seed=1)
    bias = bias if with_bias else None
    want = _jax(xq, wq, sx, sw, bias, jnp.bfloat16)
    got = tig.int8_gemm_fused(
        torch.from_numpy(xq), torch.from_numpy(wq.T.copy()),
        torch.from_numpy(sx), torch.from_numpy(sw),
        None if bias is None else torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.mean(got == want) > 0.999  # all but rounding ties are equal
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-5)


def test_exact_where_an_fp32_accumulation_is_not():
    """K = 5120 of ±127 inputs: every sum is 127²·5120 = 82,580,480 in
    magnitude, past 2²⁴, where a running fp32 sum rounds; the int32 sum
    (the plain version's, and the card's K-chunked form) does not."""
    m, k, n = 8, 5120, 16
    rng = np.random.default_rng(2)
    xq = (rng.integers(0, 2, (m, 1)) * 254 - 127).astype(np.int8) \
        * np.ones((1, k), np.int8)
    wq = (rng.integers(0, 2, (n, 1)) * 254 - 127).astype(np.int8) \
        * np.ones((1, k), np.int8)
    exact = xq.astype(np.int64) @ wq.astype(np.int64).T
    assert np.abs(exact).min() == 127 * 127 * k > 2 ** 24
    txq, twq = torch.from_numpy(xq), torch.from_numpy(wq)
    assert np.array_equal(tig.int8_matmul(txq, twq).numpy(), exact)
    ones_m, ones_n = torch.ones(m), torch.ones(n)
    got = tig.int8_gemm_plain(txq, twq, ones_m, ones_n,
                              out_dtype=torch.float32)
    assert np.array_equal(got.numpy(), exact.astype(np.float32))
    # the trap: one fp32 term at a time loses the low bits
    running = np.float32(0)
    for _ in range(k):
        running = np.float32(running + np.float32(127 * 127))
    assert running != np.float32(127 * 127 * k)
    # the card's form of the plain version: fp32 partial sums over chunks
    # of 1,024 stay below 2²⁴ and exact
    chunks = sum((txq[:, i:i + 1024].float() @ twq[:, i:i + 1024].float().T)
                 .to(torch.int32) for i in range(0, k, 1024))
    assert np.array_equal(chunks.numpy(), exact)
    want = _jax(xq, wq.T.copy(), np.ones((m, 1), np.float32),
                np.ones(n, np.float32), None, jnp.float32)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_w8a8_linear_matches_jax(out_dtype):
    """Float in, float out: activation quantization + GEMM, against the
    JAX ``w8a8_linear`` (Pallas, interpret mode) on the same weights."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 64, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 384)) * 0.02).astype(np.float32)
    bias = rng.standard_normal(384).astype(np.float32)
    q8, scale = jax_quantize(w)
    want = np.asarray(jig.w8a8_linear(
        jnp.asarray(x), jnp.asarray(q8), jnp.asarray(scale),
        jnp.asarray(bias), out_dtype=getattr(jnp, out_dtype))
        .astype(jnp.float32))
    got = tig.w8a8_linear(
        torch.from_numpy(x), torch.from_numpy(q8.T.copy()),
        torch.from_numpy(scale), torch.from_numpy(bias),
        out_dtype=getattr(torch, out_dtype))
    assert got.shape == (4, 64, 384)
    rtol = 1e-6 if out_dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=1e-5)


def test_quantlinear_w8a8_adds_the_bias_after_the_cast():
    """``_dense``'s W8A8 order (wan_model.py:193-199): rescale in fp32,
    cast to the compute dtype, then add the bias in that dtype — two bf16
    roundings, where the fused epilogue rounds once."""
    gen = torch.Generator().manual_seed(0)
    lin = QuantLinear(64, 48, act8=True)
    lin.init_random(gen)
    lin.bias.normal_(generator=gen)
    x = torch.randn(5, 64, generator=gen)
    xq, sx = tig.quantize_activations(x)
    unbiased = tig.int8_gemm_plain(xq, lin.qweight, sx, lin.scale)
    assert torch.equal(lin(x, torch.bfloat16), unbiased + lin.bias)
    fused = tig.int8_gemm_plain(xq, lin.qweight, sx, lin.scale, lin.bias)
    assert not torch.equal(lin(x, torch.bfloat16), fused)


def test_refuses_bad_operands():
    xq, wq, sx, sw, _ = (torch.from_numpy(a) for a in _operands(4, 16, 8))
    wq = wq.T.contiguous()
    with pytest.raises(ValueError, match=r"\[M, K\] and \[N, K\]"):
        tig.int8_gemm_fused(xq, wq.T, sx, sw)
    with pytest.raises(TypeError, match="int8"):
        tig.int8_gemm_fused(xq.float(), wq, sx, sw)
    with pytest.raises(ValueError, match="sx has"):
        tig.int8_gemm_fused(xq, wq, sx[:2], sw)
    with pytest.raises(TypeError, match="out_dtype"):
        tig.int8_gemm_fused(xq, wq, sx, sw, out_dtype=torch.float16)


@pytest.mark.parametrize("cd", ["bfloat16", "float32"])
def test_plain_bias_after_cast_matches_jax_dense(cd):
    """The third bias mode against the JAX ``_dense`` W8A8 branch
    (wan_model.py:193-199): rescale in fp32, cast to the compute dtype,
    then add the bias in that dtype. Both sides quantize the same
    activations to the same codes (test_torch_quantization.py), so the
    GEMM's epilogue is what is compared. In bf16 the two roundings are
    the same operations on both sides: equal bits. In fp32 the cast is
    exact and XLA may contract ``· sw + bias`` into an fma: 1e-6."""
    from moviigen_tpu.models import wan_model as jwan

    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 50, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 136)) * 0.02).astype(np.float32)
    bias = rng.standard_normal(136).astype(np.float32)
    q8, scale = jax_quantize(w)
    leaf = {"q8": jnp.asarray(q8), "scale": jnp.asarray(scale),
            "bias": jnp.asarray(bias).astype(jnp.bfloat16),
            "a8": np.ones((), np.int8)}
    want = np.asarray(jwan._dense(leaf, jnp.asarray(x), getattr(jnp, cd))
                      .astype(jnp.float32))
    xq, sx = tig.quantize_activations(torch.from_numpy(x))
    got = tig.int8_gemm_plain(
        xq.reshape(-1, 256), torch.from_numpy(q8.T.copy()), sx.reshape(-1),
        torch.from_numpy(scale), torch.from_numpy(bias).to(torch.bfloat16),
        out_dtype=getattr(torch, cd), bias_after_cast=True)
    got = got.float().numpy().reshape(want.shape)
    if cd == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    fused = tig.int8_gemm_plain(
        xq.reshape(-1, 256), torch.from_numpy(q8.T.copy()), sx.reshape(-1),
        torch.from_numpy(scale), torch.from_numpy(bias).to(torch.bfloat16),
        out_dtype=getattr(torch, cd))
    if cd == "bfloat16":  # the modes differ where the bias is rounded twice
        assert not np.array_equal(fused.float().numpy().reshape(want.shape),
                                  want)


@pytest.mark.parametrize("with_bias", [True, False])
def test_bias_after_cast_without_a_bias_is_the_plain_product(with_bias):
    """The mode flag changes nothing when there is no bias, and the two
    modes are one fp32 add apart when the output is fp32."""
    xq, wq, sx, sw, bias = (torch.from_numpy(a)
                            for a in _operands(96, 256, 128, seed=5))
    wq = wq.T.contiguous()
    b = bias if with_bias else None
    after = tig.int8_gemm_fused(xq, wq, sx, sw, b, out_dtype=torch.float32,
                                bias_after_cast=True)
    before = tig.int8_gemm_fused(xq, wq, sx, sw, b, out_dtype=torch.float32)
    assert torch.equal(after, before)
