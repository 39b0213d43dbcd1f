"""The port's quantizers against ``moviigen_tpu.ops.quantization``.

The port keeps a weight as ``[out, in]`` where the JAX leaf is
``[in, out]``; the tests transpose between the two. Quantizing is
elementwise arithmetic on fp32 (absmax, one division, round half to even,
clip) that both frameworks do in IEEE fp32, so codes and scales are held
**equal**, not close; so is dequantizing, in fp32 and in bf16 (one product
of two values already rounded to the dtype)."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from moviigen_tpu.configs import T5Config as JaxT5Config
from moviigen_tpu.configs import WAN_CONFIGS as JAX_CONFIGS
from moviigen_tpu.models import t5 as jt5
from moviigen_tpu.models import wan_model as jwan
from moviigen_tpu.ops import quantization as jq
from moviigen_tpu_torch import convert
from moviigen_tpu_torch.configs import WAN_CONFIGS, T5Config
from moviigen_tpu_torch.models.t5 import T5Encoder
from moviigen_tpu_torch.models.wan_model import WanModel
from moviigen_tpu_torch.ops import quantization as tq

JCFG = JAX_CONFIGS["t2v-tiny"].model
CFG = WAN_CONFIGS["t2v-tiny"].model
T5KW = dict(vocab_size=96, dim=32, dim_attn=32, dim_ffn=64, num_heads=4,
            num_layers=3, num_buckets=32, shared_pos=False)


def _kernel(shape, seed=0):
    """A random [.., in, out] kernel with a zero output column and values
    that land on rounding ties."""
    k = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    k[..., :, 0] = 0.0
    k[..., 0, 1] = k[..., :, 1].max() * 2  # absmax at a known place
    k[..., 1, 1] = k[..., 0, 1] * (2.5 / 127)  # a tie at code 2.5
    return k


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to_np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("shape", [(64, 48), (3, 256, 40)])
def test_quantize_linear_equals_jax(shape):
    k = _kernel(shape)
    want_q, want_s = jq.quantize_linear(k)
    got_q, got_s = tq.quantize_linear(torch.from_numpy(k).transpose(-1, -2))
    np.testing.assert_array_equal(got_q.transpose(-1, -2).numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)


@pytest.mark.parametrize("shape", [(256, 40), (2, 384, 24), (48, 16)])
def test_quantize_linear_int4_equals_jax(shape):
    """g = 128 groups, and the single group of ``in % 128`` (48)."""
    k = _kernel(shape, seed=1)
    want_q, want_s = jq.quantize_linear_int4(k)
    got_q, got_s = tq.quantize_linear_int4(
        torch.from_numpy(k).transpose(-1, -2))
    np.testing.assert_array_equal(got_q.transpose(-1, -2).numpy(), want_q)
    np.testing.assert_array_equal(got_s.transpose(-1, -2).numpy(), want_s)
    with pytest.raises(ValueError, match="even input"):
        tq.quantize_linear_int4(torch.zeros(4, 7))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_activations_equals_jax(dtype):
    x = np.random.default_rng(2).standard_normal((2, 9, 64)).astype(np.float32)
    x[0, 0] = 0.0                  # an all-zero token: the 1e-8 floor
    x[0, 1, :4] = [1.0, 2.5 / 127, -2.5 / 127, 0.5 / 127]  # ties, absmax 1
    x[0, 1, 4:] *= 0.1
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    want_q, want_s = jq.quantize_activations(xj)
    got_q, got_s = tq.quantize_activations(
        torch.from_numpy(x).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_leaf_equals_jax(bits, dtype):
    k = _kernel((3, 256, 40), seed=3)
    if bits == 8:
        q, s = jq.quantize_linear(k)
        leaf = {"q8": jnp.asarray(q), "scale": jnp.asarray(s)}
        tqw, tsc = torch.from_numpy(q), torch.from_numpy(s)
    else:
        q, s = jq.quantize_linear_int4(k)
        leaf = {"q4": jnp.asarray(q), "scale": jnp.asarray(s)}
        tqw, tsc = torch.from_numpy(q), torch.from_numpy(s).transpose(-1, -2)
    want = np.asarray(jq.dequantize_leaf(leaf, getattr(jnp, dtype))
                      .astype(jnp.float32))
    got = tq.dequantize_leaf(tqw.transpose(-1, -2).contiguous(),
                             tsc.contiguous(), getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().transpose(-1, -2).numpy(), want)


def _assert_trees_equal(got, want, path=""):
    """Same keys, dtypes, shapes and values, leaf by leaf."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (path, sorted(got), sorted(want))
        for key in want:
            _assert_trees_equal(got[key], want[key], f"{path}/{key}")
        return
    g = _to_np(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype, w.dtype,
                                                       g.shape, w.shape)
    np.testing.assert_array_equal(g, w, err_msg=path)


@pytest.mark.parametrize("bits,act8", [(8, False), (8, True), (4, False)])
def test_quantize_wan_params_picks_the_same_leaves(bits, act8):
    """The port quantizes a model in place; exported as a JAX tree it
    equals ``quantize_wan_params`` of the same weights, leaf for leaf:
    the same linears quantized, the rest untouched, the a8 marker set."""
    params = _np(jwan.init_params(jax.random.PRNGKey(0), JCFG, jnp.bfloat16))
    want = jq.quantize_wan_params(params, bits=bits, act8=act8)
    model = convert.load_wan_params(WanModel(CFG, dtype=torch.bfloat16),
                                    params)
    tq.quantize_wan_params(model, bits=bits, act8=act8)
    _assert_trees_equal(convert.wan_params_tree(model), want)
    kinds = {type(m).__name__ for m in model.blocks[0].modules()}
    assert "Linear" not in kinds and "QuantLinear" in kinds
    assert isinstance(model.head, torch.nn.Linear)
    with pytest.raises(ValueError, match="requires bits=8"):
        tq.quantize_wan_params(model, bits=4, act8=True)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_t5_params_picks_the_same_leaves(bits):
    params = _np(jt5.init_params(jax.random.PRNGKey(1), JaxT5Config(**T5KW),
                                 dtype=jnp.bfloat16))
    want = jq.quantize_t5_params(params, bits=bits)
    model = convert.load_t5_params(
        T5Encoder(T5Config(**T5KW), dtype=torch.bfloat16), params)
    tq.quantize_t5_params(model, bits=bits)
    _assert_trees_equal(convert.t5_params_tree(model), want)
    assert isinstance(model.token_embedding, tq.QuantEmbedding)


@pytest.mark.parametrize("quant", ["int8", "int4", "w8a8"])
def test_quantized_tree_round_trips_through_the_modules(quant):
    """JAX quantized tree → ``WanModel(quant=...)`` → tree: equal."""
    params = _np(jwan.init_params(jax.random.PRNGKey(2), JCFG, jnp.bfloat16))
    tree = jq.quantize_wan_params(params, bits=4 if quant == "int4" else 8,
                                  act8=quant == "w8a8")
    model = convert.load_wan_params(
        WanModel(CFG, dtype=torch.bfloat16, quant=quant), tree)
    _assert_trees_equal(convert.wan_params_tree(model), tree)
    with pytest.raises(TypeError, match="does not fit"):
        convert.load_wan_params(WanModel(CFG, dtype=torch.bfloat16), tree)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_file_crosses_packages(tmp_path, bits):
    """A quantized safetensors cache written by either package loads in
    the other to equal arrays, metadata included."""
    params = _np(jwan.init_params(jax.random.PRNGKey(3), JCFG, jnp.bfloat16))
    tree = jq.quantize_wan_params(params, bits=bits, act8=bits == 8)
    meta = {"source_fingerprint": "a.safetensors:12:34", "tag": f"dit_{bits}"}

    by_jax = str(tmp_path / "jax.safetensors")
    jq.save_quantized_checkpoint(by_jax, tree, metadata=meta)
    assert tq.read_quantized_metadata(by_jax) == meta
    _assert_trees_equal(tq.load_quantized_checkpoint(by_jax), tree)

    by_port = str(tmp_path / "port.safetensors")
    model = convert.load_wan_params(
        WanModel(CFG, dtype=torch.bfloat16, quant="w8a8" if bits == 8
                 else "int4"), tree)
    tq.save_quantized_checkpoint(by_port, convert.wan_params_tree(model),
                                 metadata=meta)
    assert jq.read_quantized_metadata(by_port) == meta
    _assert_trees_equal(jq.load_quantized_checkpoint(by_port), tree)
    assert tq.read_quantized_metadata(
        str(tmp_path / "jax.safetensors")) == meta


def test_random_quantized_init_is_seeded_and_in_range():
    gen = torch.Generator().manual_seed(0)
    model = WanModel(CFG, dtype=torch.bfloat16, quant="w8a8").init_weights(gen)
    lin = model.blocks[0].self_attn.q
    assert lin.act8 and lin.qweight.dtype == torch.int8
    assert int(lin.qweight.min()) >= -127
    assert float(lin.qweight.float().std()) > 50
    assert float(lin.scale[0]) == pytest.approx(0.02 / CFG.dim ** 0.5)
    assert not bool(lin.bias.any())
    again = WanModel(CFG, dtype=torch.bfloat16, quant="w8a8").init_weights(
        torch.Generator().manual_seed(0))
    assert torch.equal(again.blocks[1].ffn_fc2.qweight,
                       model.blocks[1].ffn_fc2.qweight)
    t5 = T5Encoder(T5Config(**T5KW), quant_bits=4).init_weights(gen)
    assert t5.blocks[0].fc1.qweight.dtype == torch.uint8
    assert float(t5.token_embedding.scale[0]) == pytest.approx(1 / 127)


def _hard_rows(m, k, seed=0):
    """[m, k] fp32 rows that are hard for the activation quantization:
    every third row sits on exact .5 ties of x / sx (absmax 127·2^e makes
    sx = 2^e exactly, and (c + 0.5)·2^e is exact in bf16 too), every
    fourth is all zero (sx = 1e-8 / 127), every fifth is one spike in
    zeros; the rest are Gaussian at random scales."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32) \
        * np.float32(2.0) ** rng.integers(-8, 8, (m, 1))
    for r in range(m):
        if r % 3 == 0:
            step = np.float32(2.0) ** rng.integers(-6, 3)
            x[r] = (rng.integers(-126, 126, k) + 0.5) * step
            x[r, rng.integers(k)] = 127 * step * rng.choice([-1, 1])
        elif r % 4 == 0:
            x[r] = 0.0
        elif r % 5 == 0:
            x[r] = 0.0
            x[r, rng.integers(k)] = rng.standard_normal() * 50
    return x


@pytest.mark.parametrize("k", [16, 5120, 13824])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_activations_plain_bit_equal_to_jax_on_hard_rows(dtype, k):
    """The plain version (what the kernel is held to on the card) against
    JAX ``quantize_activations`` bit for bit: the .5 ties round to even on
    both sides, the all-zero rows take the 1e-8 floor, and sx is the
    correctly rounded quotient by 127 on both."""
    x = _hard_rows(24, k, seed=k)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    want_q, want_s = jq.quantize_activations(xj)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got_q, got_s = tq.quantize_activations_plain(xt)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    ties = got_q[0].float() - xt[0].float() / got_s[0]
    assert bool((ties.abs() == 0.5).sum() > k // 4)  # the ties are there
    assert float(got_s[4, 0]) == np.float32(1e-8) / np.float32(127)


def test_quantize_activations_on_cpu_is_the_plain_version():
    """A CPU tensor runs the plain version and counts no kernel launch."""
    x = torch.from_numpy(_hard_rows(6, 48, seed=1)).reshape(2, 3, 48)
    before = tq.quantize_activations.launches
    got_q, got_s = tq.quantize_activations(x)
    want_q, want_s = tq.quantize_activations_plain(x)
    assert tq.quantize_activations.launches == before
    assert got_q.shape == (2, 3, 48) and got_s.shape == (2, 3, 1)
    assert torch.equal(got_q, want_q) and torch.equal(got_s, want_s)


@pytest.mark.parametrize("cd", ["bfloat16", "float32"])
def test_quantlinear_w8a8_equals_jax_dense(cd):
    """``QuantLinear`` W8A8, which now hands its bias to the GEMM's
    bias-after-cast epilogue, against the JAX ``_dense`` on the same
    quantized leaf: equal bits in bf16, 1e-6 in fp32 (where XLA may
    contract the rescale and the bias add into an fma)."""
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((192, 96)) * 0.05).astype(np.float32)
    bias = rng.standard_normal(96).astype(np.float32)
    x = rng.standard_normal((2, 40, 192)).astype(np.float32)
    lin = torch.nn.Linear(192, 96, dtype=torch.bfloat16)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T.copy()))
        lin.bias.copy_(torch.from_numpy(bias))
    q = tq.QuantLinear.from_linear(lin, act8=True)
    leaf = {"q8": jnp.asarray(q.qweight.numpy().T),
            "scale": jnp.asarray(q.scale.numpy()),
            "bias": jnp.asarray(_to_np(q.bias)),
            "a8": np.ones((), np.int8)}
    want = np.asarray(jwan._dense(leaf, jnp.asarray(x), getattr(jnp, cd))
                      .astype(jnp.float32))
    with torch.no_grad():
        got = q(torch.from_numpy(x), getattr(torch, cd)).float().numpy()
    if cd == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
