"""The port's VAE encode (full-tensor and streaming) against the JAX
package's, with the JAX parameters carried across by ``convert``: fp32 at
2e-4 (the decode tests' tolerance), a bf16 bound, and the 4n+1 rule of
the streaming encode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moviigen_tpu.models import vae as jvae
from moviigen_tpu.models.vae_streaming import \
    encode_streaming as jax_encode_streaming
from moviigen_tpu_torch.convert import vae_params_to_torch
from moviigen_tpu_torch.models import vae as tvae
from moviigen_tpu_torch.models import vae_streaming as tvs
from test_torch_vae import CFG, JCFG, _random_tree


@pytest.fixture(scope="module")
def pair():
    params = _random_tree(seed=11)
    return params, vae_params_to_torch(params)


_jax_encode = jax.jit(lambda p, v: jvae.encode(p, v, JCFG))


def _video(frames, seed=1, h=32, w=48):
    return np.random.default_rng(seed).uniform(
        -1.0, 1.0, (1, 3, frames, h, w)).astype(np.float32)


@pytest.mark.parametrize("frames", [1, 5, 9])
def test_encode_fp32(pair, frames):
    jp, tp = pair
    x = _video(frames)
    want = np.asarray(_jax_encode(jp, jnp.asarray(x)))
    got = tvae.encode(tp, torch.from_numpy(x), CFG).numpy()
    assert got.shape == want.shape == (1, CFG.z_dim, (frames - 1) // 4 + 1,
                                       4, 6)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("frames", [1, 5, 9])
def test_encode_streaming_fp32(pair, frames):
    """The streaming encode against JAX's, and against the port's own
    full-tensor encode (the same convs in another order of frames)."""
    jp, tp = pair
    x = _video(frames, seed=2)
    want = np.asarray(jax_encode_streaming(jp, jnp.asarray(x), JCFG))
    got = tvs.encode_streaming(tp, torch.from_numpy(x), CFG).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    full = tvae.encode(tp, torch.from_numpy(x), CFG).numpy()
    np.testing.assert_allclose(got, full, atol=2e-5, rtol=1e-4)


def test_encode_bf16(pair):
    """bf16 encode (the preprocess CLI's default): JAX casts the input and
    lets XLA accumulate each conv, PyTorch's bf16 conv3d accumulates in
    fp32 in another order, so each bf16 rounding (2^-8 of the value) can
    land differently over the ~25 layers. The bound: the two bf16 encodes
    within 5e-2 of the latents' largest magnitude of each other, and each
    within 5e-2 of the fp32 encode's; a wrong layer is off by O(1)."""
    jp, tp = pair
    x = _video(9, seed=3)
    want = np.asarray(_jax_encode(jp, jnp.asarray(x, jnp.bfloat16))
                      .astype(jnp.float32))
    got_t = tvae.encode(tp, torch.from_numpy(x).bfloat16(), CFG)
    assert got_t.dtype == torch.bfloat16
    got = got_t.float().numpy()
    ref = tvae.encode(tp, torch.from_numpy(x), CFG).numpy()
    scale = np.abs(ref).max()
    assert np.abs(got - want).max() <= 5e-2 * scale
    for out in (got, want):
        assert np.abs(out - ref).max() <= 5e-2 * scale


@pytest.mark.parametrize("frames", [3, 6, 8])
def test_streaming_encode_needs_4n_plus_1_frames(pair, frames):
    """JAX fails to reshape the frames after the first into chunks of 4;
    under 5 frames it encodes the first frame alone and drops the rest
    without an error. The port raises for every T that is not 4n+1."""
    jp, tp = pair
    x = _video(frames, seed=4)
    if frames < 5:
        out = jax_encode_streaming(jp, jnp.asarray(x), JCFG)
        assert out.shape[2] == 1
    else:
        with pytest.raises(TypeError, match="reshape"):
            jax_encode_streaming(jp, jnp.asarray(x), JCFG)
    with pytest.raises(ValueError, match="4n\\+1"):
        tvs.encode_streaming(tp, torch.from_numpy(x), CFG)


@pytest.mark.parametrize("threshold,streams", [(0, True), (10 ** 9, False)])
def test_encode_video_streams_above_its_threshold(pair, monkeypatch,
                                                  threshold, streams):
    """``encode_video`` (what the preprocess CLIs call) takes the streaming
    path above STREAMING_ENCODE_PIXELS input pixels and the full-tensor
    one below; both give the JAX latents."""
    jp, tp = pair
    called = []
    real = tvs.encode_streaming
    monkeypatch.setattr(tvs, "STREAMING_ENCODE_PIXELS", threshold)
    monkeypatch.setattr(tvs, "encode_streaming",
                        lambda *a: called.append(1) or real(*a))
    x = _video(5, seed=5)
    got = tvs.encode_video(tp, torch.from_numpy(x), CFG).numpy()
    assert bool(called) == streams
    want = np.asarray(_jax_encode(jp, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("side", ["encoder", "decoder"])
def test_streaming_caches_own_their_frames(pair, side):
    """The caches a chunk leaves for the next hold their own 1 or 2
    frames, not views of the layer's whole input: a view keeps every
    conv's input of the chunk alive until the next chunk, which on the
    card took the streaming decode's memory to 4× the full-tensor
    decode's per pixel."""
    _, tp = pair
    if side == "encoder":
        x = torch.from_numpy(_video(5, seed=6))
        chunk, p, first, rest = (tvs._encoder_chunk, tp["encoder"],
                                 x[:, :, :1], x[:, :, 1:])
    else:
        z = torch.from_numpy(np.random.default_rng(6).standard_normal(
            (1, CFG.z_dim, 3, 4, 6)).astype(np.float32))
        chunk, p, first, rest = (tvs._decoder_chunk, tp["decoder"],
                                 z[:, :, :1], z[:, :, 1:])
    _, caches = chunk(p, first, None, first=True)
    _, caches = chunk(p, rest, caches, first=False)
    assert len(caches) > 10
    for c in caches:
        assert c.shape[2] in (1, 2)
        assert c.untyped_storage().nbytes() == c.numel() * c.element_size()
