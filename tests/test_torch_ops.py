"""The port's ops against the JAX package's, in fp32: norms, 3D RoPE (with
positions past the table), the sinusoidal time embedding and the
attention entry point's plain backend against JAX ``backend="xla"``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moviigen_tpu.models import wan_model as jwan
from moviigen_tpu.ops.attention import attention as jax_attention
from moviigen_tpu.ops import norms as jnorms
from moviigen_tpu.ops import rope as jrope
from moviigen_tpu_torch.models import wan_model as twan
from moviigen_tpu_torch.ops import attention as tattn
from moviigen_tpu_torch.ops import norms as tnorms
from moviigen_tpu_torch.ops import rope as trope

RNG = np.random.default_rng(0)
X = RNG.standard_normal((2, 7, 48)).astype(np.float32) * 3.0
W = RNG.standard_normal(48).astype(np.float32)
B = RNG.standard_normal(48).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("name,jfn,tfn", [
    ("rms_norm", lambda x: jnorms.rms_norm(x, jnp.asarray(W), eps=1e-6),
     lambda x: tnorms.rms_norm(x, _t(W), eps=1e-6)),
    ("t5_rms_norm", lambda x: jnorms.t5_rms_norm(x, jnp.asarray(W)),
     lambda x: tnorms.t5_rms_norm(x, _t(W))),
    ("layer_norm", lambda x: jnorms.layer_norm(x, jnp.asarray(W),
                                               jnp.asarray(B)),
     lambda x: tnorms.layer_norm(x, _t(W), _t(B))),
    ("layer_norm_keep_fp32", lambda x: jnorms.layer_norm(x, keep_fp32=True),
     lambda x: tnorms.layer_norm(x, keep_fp32=True)),
])
def test_norms(name, jfn, tfn):
    want = np.asarray(jfn(jnp.asarray(X)))
    got = tfn(_t(X)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5, err_msg=name)


def test_norm_dtypes_follow_jax():
    """bf16 input: rms_norm and layer_norm return bf16, keep_fp32 keeps
    fp32, t5_rms_norm with a bf16 weight returns bf16."""
    xb = _t(X).bfloat16()
    assert tnorms.rms_norm(xb, _t(W)).dtype == torch.bfloat16
    assert tnorms.layer_norm(xb).dtype == torch.bfloat16
    assert tnorms.layer_norm(xb, keep_fp32=True).dtype == torch.float32
    assert tnorms.t5_rms_norm(xb, _t(W).bfloat16()).dtype == torch.bfloat16


@pytest.mark.parametrize("grid,l_extra", [((3, 4, 5), 0), ((2, 3, 4), 5)])
def test_rope(grid, l_extra):
    """Tables and rotation; ``l_extra`` positions past the table pass
    through unrotated (ref model.py:63)."""
    d = 32
    jt = jrope.rope_3d_freqs(grid, d)
    tt = trope.rope_3d_freqs(grid, d)
    np.testing.assert_array_equal(tt.cos.numpy(), np.asarray(jt.cos))
    np.testing.assert_array_equal(tt.sin.numpy(), np.asarray(jt.sin))
    l = grid[0] * grid[1] * grid[2] + l_extra
    x = RNG.standard_normal((2, l, 3, d)).astype(np.float32)
    want = np.asarray(jrope.rope_apply(jnp.asarray(x), jt))
    got = trope.rope_apply(_t(x), tt).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    if l_extra:
        np.testing.assert_array_equal(got[:, -l_extra:], x[:, -l_extra:])


def test_sinusoidal_embedding():
    t = np.array([0.0, 1.0, 250.5, 999.0], np.float32)
    want = np.asarray(jwan.sinusoidal_embedding_1d(64, jnp.asarray(t)))
    got = twan.sinusoidal_embedding_1d(64, _t(t)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("k_lens", [None, (40, 13)])
def test_attention_plain_vs_jax_xla(k_lens):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 33, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
    v = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
    jk = None if k_lens is None else jnp.asarray(k_lens, jnp.int32)
    tk = None if k_lens is None else torch.tensor(k_lens)
    want = np.asarray(jax_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), k_lens=jk,
        backend="xla", compute_dtype=jnp.float32))
    got = tattn.attention(_t(q), _t(k), _t(v), k_lens=tk, backend="plain",
                          compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    auto = tattn.attention(_t(q), _t(k), _t(v), k_lens=tk,
                           compute_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(auto, got)  # CPU "auto" is the plain path
    with pytest.raises(ValueError, match="backend"):
        tattn.attention(_t(q), _t(k), _t(v), backend="pallas")
