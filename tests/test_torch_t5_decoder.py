"""The port's umT5 decoder (``models/t5.py::T5Decoder``) against
``moviigen_tpu.models.t5.decode`` in fp32 at t2v-tiny's T5 width, within
atol 5e-5 / rtol 1e-4 (the bound of tests/test_t5_parity.py). The port
draws a random decoder, writes it in the reference layout, and the same
dict goes through the JAX package's strict converter."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moviigen_tpu.configs import WAN_CONFIGS as JAX_CONFIGS
from moviigen_tpu.models import t5 as jt5
from moviigen_tpu_torch.configs import WAN_CONFIGS
from moviigen_tpu_torch.models import t5

CFG = WAN_CONFIGS["t2v-tiny"].t5
JCFG = JAX_CONFIGS["t2v-tiny"].t5
B, S, L = 2, 11, 17


@pytest.fixture(scope="module")
def pair():
    model = t5.T5Decoder(CFG, dtype=torch.float32).init_weights(
        torch.Generator().manual_seed(0))
    sd = t5.t5_decoder_state_dict(model)
    params = jt5.convert_t5_decoder_state_dict(
        {k: v.numpy() for k, v in sd.items()}, JCFG, dtype=jnp.float32)
    return model, sd, params


def _inputs():
    rng = np.random.default_rng(1)
    # ids past the vocabulary are clipped to its last entry on both sides
    ids = rng.integers(0, CFG.vocab_size + 8, size=(B, S))
    enc = rng.standard_normal((B, L, CFG.dim)).astype(np.float32)
    enc_mask = np.ones((B, L), np.int64)
    enc_mask[0, 9:] = 0
    dec_mask = np.ones((B, S), np.int64)
    dec_mask[1, 6:] = 0
    return ids, enc, enc_mask, dec_mask


@pytest.mark.parametrize("enc_masked", [False, True])
@pytest.mark.parametrize("dec_mask", [None, "numpy", "jnp"])
def test_decode_matches_jax(pair, enc_masked, dec_mask):
    """JAX builds the 3D causal mask with numpy for a numpy ``mask`` and
    with ``jnp.tril`` otherwise (t5.py:150-156): both branches."""
    model, _, params = pair
    ids, enc, enc_mask, mask = _inputs()
    jmask = {None: None, "numpy": mask, "jnp": jnp.asarray(mask)}[dec_mask]
    want = np.asarray(jt5.decode(
        params, jnp.asarray(ids), jnp.asarray(enc),
        jnp.asarray(enc_mask) if enc_masked else None, JCFG, mask=jmask))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(enc),
                    torch.from_numpy(enc_mask) if enc_masked else None,
                    None if dec_mask is None else torch.from_numpy(mask))
    assert got.shape == (B, S, CFG.dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=1e-4)


def test_masks_change_the_output(pair):
    """The masks are live: dropping either changes the rows they touch."""
    model, _, _ = pair
    ids, enc, enc_mask, mask = (torch.from_numpy(a) for a in _inputs())
    with torch.no_grad():
        full = model(ids, enc, enc_mask, mask)
        no_enc = model(ids, enc, None, mask)
        no_dec = model(ids, enc, enc_mask, None)
    assert not torch.allclose(full[0], no_enc[0])
    assert torch.equal(full[1], no_enc[1])  # row 1 masks no encoder key
    assert torch.equal(full[1, :6], no_dec[1, :6])  # causal: keys < 6 only
    assert not torch.allclose(full[1, 6:], no_dec[1, 6:])


def test_decoder_keys_match_jax_and_module(pair):
    model, sd, _ = pair
    keys = t5.expected_t5_decoder_keys(CFG)
    assert keys == jt5.expected_t5_decoder_keys(JCFG)
    assert set(sd) == keys
    assert len(dict(model.named_parameters())) == len(keys)


def test_state_dict_round_trip_and_strict_census(pair):
    model, sd, _ = pair
    fresh = t5.load_t5_decoder_state_dict(
        t5.T5Decoder(CFG, dtype=torch.float32), sd)
    for k, v in t5.t5_decoder_state_dict(fresh).items():
        assert torch.equal(v, sd[k]), k
    extra = dict(sd, **{"blocks.0.unused.weight": torch.zeros(1)})
    with pytest.raises(ValueError, match="not consumed"):
        t5.load_t5_decoder_state_dict(t5.T5Decoder(CFG), extra)
    with pytest.raises(ValueError, match="not consumed"):
        jt5.convert_t5_decoder_state_dict(
            {k: v.numpy() for k, v in extra.items()}, JCFG)
    missing = {k: v for k, v in sd.items() if "cross_attn.k" not in k}
    with pytest.raises(KeyError, match="missing key"):
        t5.load_t5_decoder_state_dict(t5.T5Decoder(CFG), missing)
