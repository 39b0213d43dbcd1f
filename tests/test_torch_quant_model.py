"""The port's quantized DiT forward against the JAX package's, for int8,
int4 and W8A8, on t2v-tiny with the quantized JAX tree carried across by
``convert``. The block linears get random **non-zero biases**: with the
zero biases of a random init the two places a W8A8 bias can be added
(before or after the cast to the compute dtype) would not differ."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moviigen_tpu.models import wan_model as jwan
from moviigen_tpu.ops import quantization as jq
from moviigen_tpu_torch.convert import load_wan_params
from moviigen_tpu_torch.models import wan_model as twan
from moviigen_tpu_torch.models.wan_model import WanModel

from test_torch_wan_model import CFG, _run_both, jax_params_with_head

QUANTS = ("int8", "int4", "w8a8")


@functools.lru_cache(maxsize=None)
def _quantized_pair(quant, dtype, seed=0):
    """(JAX quantized tree, the port's model holding the same leaves)."""
    params = jax_params_with_head(getattr(jnp, dtype), seed)
    rng = np.random.default_rng(seed + 7)
    for group in ("self_attn", "cross_attn", "ffn"):
        for leaf in params["blocks"][group].values():
            if "bias" in leaf:
                leaf["bias"] = (rng.standard_normal(leaf["bias"].shape) * 0.3
                                ).astype(leaf["bias"].dtype)
    tree = jq.quantize_wan_params(params, bits=4 if quant == "int4" else 8,
                                  act8=quant == "w8a8")
    model = load_wan_params(
        WanModel(CFG, dtype=getattr(torch, dtype), quant=quant), tree)
    return tree, model


@pytest.fixture
def fuse_limit(monkeypatch):
    """Set ``_FUSE_BYTES_LIMIT`` in both packages (JAX reads it while
    tracing, so its compiled programs are dropped before and after)."""
    def set_limit(value):
        jax.clear_caches()
        monkeypatch.setattr(jwan, "_FUSE_BYTES_LIMIT", value)
        monkeypatch.setattr(twan, "_FUSE_BYTES_LIMIT", value)
    yield set_limit
    jax.clear_caches()


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [True, False])
def test_dense_multi_w8a8_matches_jax(fuse_limit, fused, cd):
    """One block's q/k/v from the same input, on each side of the fuse
    rule: under the limit the bias is added in fp32 before the cast, over
    it in the compute dtype after the cast. Both sides see the same int8
    codes (``quantize_activations`` is equal, test_torch_quantization.py)
    and the same exact int32 sums, so only the fp32 epilogue can differ,
    by the last bit where XLA contracts ``· sw + bias``: fp32 at 1e-6
    relative; bf16 equal but for such ties, which move one bf16 step
    (2^-8)."""
    fuse_limit((1 << 30) if fused else 0)
    tree, model = _quantized_pair("w8a8", "bfloat16")
    x = np.random.default_rng(1).standard_normal((2, 24, CFG.dim)) \
        .astype(np.float32)
    leaves = [jax.tree_util.tree_map(lambda a: jnp.asarray(a[1]),
                                     tree["blocks"]["self_attn"][p])
              for p in "qkv"]
    want = jwan._dense_multi(leaves, jnp.asarray(x), getattr(jnp, cd))
    attn = model.blocks[1].self_attn
    with torch.no_grad():
        got = twan._dense_multi([attn.q, attn.k, attn.v],
                                torch.from_numpy(x), getattr(torch, cd))
    for g, w in zip(got, want):
        g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32))
        if cd == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
        else:
            assert np.mean(g == w) > 0.995
            np.testing.assert_allclose(g, w, rtol=2 ** -7, atol=1e-6)
    if cd == "bfloat16":  # the two orders do differ, so the rule is seen
        with torch.no_grad():
            other = twan._dense(attn.q, torch.from_numpy(x), torch.bfloat16) \
                if fused else None
        if other is not None:
            assert not torch.equal(other, got[0])


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_weight_only_forward_fp32(quant):
    """fp32 compute: both sides dequantize to the same fp32 weights
    (test_torch_quantization.py) and run the fp32 forward that
    test_torch_wan_model.py holds to 5e-4; the same bound holds here."""
    tree, model = _quantized_pair(quant, "float32")
    got, want = _run_both(tree, model, (3, 8, 8), 48, "float32", "float32")
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_weight_only_forward_bf16(quant):
    """bf16 params and compute: the dequantized weights are equal, but
    every bf16 product and sum rounds at other places in the two
    frameworks (8 mantissa bits, 2^-8 = 3.9e-3 per rounding site) over 4
    blocks; 3e-2 of the prediction's norm bounds the drift (measured
    ~6e-3), a wrong scale or nibble is off by O(1)."""
    tree, model = _quantized_pair(quant, "bfloat16")
    got, want = _run_both(tree, model, (3, 8, 8), 48, "bfloat16", "float32")
    assert _rel(got, want) < 3e-2


@pytest.mark.parametrize("cd,bound,fused", [
    ("float32", 2e-2, True), ("bfloat16", 4e-2, True),
    ("bfloat16", 4e-2, False)])  # in fp32 the two bias orders are one
def test_w8a8_forward(fuse_limit, fused, cd, bound):
    """W8A8 cannot be held to 5e-4 even in fp32: a 1e-6 difference
    upstream (a sum taken in another order) can flip a ``round(x / sx)``
    tie and move one activation code by a whole step, 1/127 = 7.9e-3 of
    its token's absmax, which every later linear quantizes again. The
    flips are few and independent, so the norm-relative difference of
    the prediction stays small: measured 3e-7 in fp32 (no tie flipped
    with these inputs; one flipped code of 64 would move its token's
    projections by about 1e-2) and 3.7e-3 in bf16, the bf16 drift of the
    weight-only case; 2e-2 / 4e-2 bound them, while a wrong scale,
    transpose or bias order in all 10 linears is off by O(1). The per-op
    tests above hold the same code path to exactness."""
    fuse_limit((1 << 30) if fused else 0)
    tree, model = _quantized_pair("w8a8", cd)
    got, want = _run_both(tree, model, (3, 8, 8), 48, cd, "float32")
    assert np.abs(want).max() > 1e-2
    rel = _rel(got, want)
    print(f"w8a8 {cd} fused={fused}: rel {rel:.3e}")
    assert rel < bound


def test_quant_mode_is_validated():
    with pytest.raises(ValueError, match="int8|int4|w8a8"):
        WanModel(CFG, quant="fp8")
