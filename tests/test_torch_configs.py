"""The port's config registry and tokenizer against the JAX package's:
the same configs field by field, the same size tables, the same
``__post_init__`` refusals, and the same token ids from the vendored
``assets/tiny_tokenizer`` and from the hash fallback."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from moviigen_tpu import configs as jcfg
from moviigen_tpu.models import tokenizer as jtok
from moviigen_tpu_torch import configs as tcfg
from moviigen_tpu_torch.models import tokenizer as ttok

ASSET = os.path.join(os.path.dirname(__file__), "..", "assets",
                     "tiny_tokenizer")
PROMPTS = ["A  cinematic   shot of a CAT walking on the beach",
           "two cats &amp; a dog_fight,   on stage!", ""]


@pytest.mark.parametrize("name", sorted(jcfg.WAN_CONFIGS))
def test_registry_matches(name):
    assert dataclasses.asdict(tcfg.WAN_CONFIGS[name]) \
        == dataclasses.asdict(jcfg.WAN_CONFIGS[name])
    assert tcfg.WAN_CONFIGS[name].torch_param_dtype == torch.bfloat16
    assert tcfg.WAN_CONFIGS[name].model.head_dim \
        == jcfg.WAN_CONFIGS[name].model.head_dim


def test_size_tables_match():
    assert tcfg.SIZE_CONFIGS == jcfg.SIZE_CONFIGS
    assert tcfg.MAX_AREA_CONFIGS == jcfg.MAX_AREA_CONFIGS
    assert tcfg.SUPPORTED_SIZES == jcfg.SUPPORTED_SIZES


@pytest.mark.parametrize("bad", [
    dict(model_type="v2v"), dict(stream_impl="scan"), dict(ffn_chunk=0),
    dict(attn_head_chunk=3), dict(attn_o_chunk=8),
    dict(attn_head_chunk=2, attn_bwd_chunk=8),
    dict(ffn_chunk=8, ffn_bwd_chunk=8),
])
def test_post_init_refuses_what_jax_refuses(bad):
    base = jcfg.WAN_CONFIGS["t2v-tiny"].model
    with pytest.raises(ValueError):
        dataclasses.replace(base, **bad)
    with pytest.raises(ValueError):
        tcfg.WAN_CONFIGS["t2v-tiny"].model.replace(**bad)


def test_cross_attn_backend_takes_the_ports_backends():
    base = tcfg.WAN_CONFIGS["t2v-tiny"].model
    assert base.replace(cross_attn_backend="plain").cross_attn_backend \
        == "plain"
    with pytest.raises(ValueError):
        base.replace(cross_attn_backend="pallas")


@pytest.mark.parametrize("clean", ["whitespace", "lower", "canonicalize"])
def test_hf_tokenizer_matches(clean):
    tj = jtok.load_tokenizer(ASSET, seq_len=16, clean=clean)
    tt = ttok.load_tokenizer(ASSET, seq_len=16, clean=clean)
    assert isinstance(tt, ttok.HuggingfaceTokenizer)
    ij, mj = tj(PROMPTS, return_mask=True, add_special_tokens=True)
    it, mt = tt(PROMPTS, return_mask=True, add_special_tokens=True)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(mt, mj)


def test_hash_fallback_matches_within_a_process():
    """Python's ``hash()`` is salted per process: the two packages agree
    within one process, which is all the parity tests need."""
    ij, mj = jtok.HashTokenizer(seq_len=12, vocab_size=128)(
        PROMPTS, return_mask=True)
    it, mt = ttok.HashTokenizer(seq_len=12, vocab_size=128)(
        PROMPTS, return_mask=True)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(mt, mj)
    assert isinstance(ttok.load_tokenizer("no/such/tokenizer", seq_len=12),
                      ttok.HashTokenizer)
