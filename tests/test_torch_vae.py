"""The port's VAE decode (full and streaming) against the JAX package's,
with the JAX parameters carried across by ``convert``: fp32 at 2e-4 (the
tolerance of tests/test_vae_parity.py), and the bf16 decode dtype."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moviigen_tpu.configs import VAEConfig as JaxVAEConfig
from moviigen_tpu.models import vae as jvae
from moviigen_tpu.models.vae_streaming import \
    decode_streaming as jax_decode_streaming
from moviigen_tpu_torch.configs import VAEConfig
from moviigen_tpu_torch.convert import vae_params_to_torch
from moviigen_tpu_torch.models import vae as tvae
from moviigen_tpu_torch.models.vae_streaming import decode_streaming

JCFG = JaxVAEConfig(dim=8, z_dim=4)
CFG = VAEConfig(dim=8, z_dim=4)


def _random_tree(seed=7):
    """The JAX ``init_params`` tree (shapes from ``jax.eval_shape``, no
    compile) filled from numpy: fan-in-scaled kernels, non-zero biases
    and gammas near 1 — also a non-zero mid-attention proj, which
    ``init_params`` zeroes."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jvae.init_params(k, JCFG),
                            jax.random.PRNGKey(0))

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            bound = 1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
            a = rng.uniform(-bound, bound, leaf.shape)
        elif name == "gamma":
            a = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        else:
            a = 0.1 * rng.standard_normal(leaf.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def pair():
    params = _random_tree()
    return params, vae_params_to_torch(params)


_jax_decode = jax.jit(lambda p, z: jvae.decode(p, z, JCFG))


def _z(frames, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (1, CFG.z_dim, frames, 4, 6)).astype(np.float32)


@pytest.mark.parametrize("frames", [1, 3])
def test_decode_fp32(pair, frames):
    jp, tp = pair
    z = _z(frames)
    want = np.asarray(_jax_decode(jp, jnp.asarray(z)))
    got = tvae.decode(tp, torch.from_numpy(z), CFG).numpy()
    assert got.shape == want.shape == (1, 3, 1 + 4 * (frames - 1), 32, 48)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("frames,chunk", [(5, None), (5, 2), (4, 3)])
def test_decode_streaming_fp32(pair, frames, chunk):
    jp, tp = pair
    z = _z(frames, seed=2)
    want = np.asarray(jax_decode_streaming(jp, jnp.asarray(z), JCFG,
                                           chunk_frames=chunk))
    got = decode_streaming(tp, torch.from_numpy(z), CFG,
                           chunk_frames=chunk).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    full = tvae.decode(tp, torch.from_numpy(z), CFG).numpy()
    np.testing.assert_allclose(got, full, atol=2e-5, rtol=1e-4)


def test_decode_bf16(pair):
    """bf16 decode dtype (the pipeline default): both sides compute every
    conv in bf16 with other accumulation orders, so each bf16 rounding
    (2^-8 of the value) can land differently; over the ~30 layers the
    outputs stay within 0.1 of each other on a [-1, 1] scale, and both
    stay within a 30 dB PSNR of the fp32 decode."""
    jp, tp = pair
    z = _z(3, seed=3)
    want = np.asarray(_jax_decode(jp, jnp.asarray(z, jnp.bfloat16))
                      .astype(jnp.float32))
    got_t = tvae.decode(tp, torch.from_numpy(z).bfloat16(), CFG)
    assert got_t.dtype == torch.bfloat16
    got = got_t.float().numpy()
    assert np.abs(got - want).max() < 0.1
    ref = tvae.decode(tp, torch.from_numpy(z), CFG).numpy()
    for out in (got, want):
        psnr = 10 * np.log10(4.0 / np.mean((out - ref) ** 2))
        assert psnr > 30.0, psnr
