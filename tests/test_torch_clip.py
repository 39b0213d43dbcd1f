"""The port's CLIP tower (``models/clip.py``), its bicubic resize
(``ops/resize.py``) and the fp32 path of its flash attention against the
JAX package.

The towers are tiny (``tests/test_i2v.py``'s vision shape, a small
XLM-RoBERTa); the weights come from the JAX init, or from a random
reference-layout ``.pth``, and cross through ``convert``. Everything runs
in fp32, as the i2v path runs the CLIP."""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl

from moviigen_tpu.models import clip as jclip
from moviigen_tpu.ops import flash_attention as jfa
from moviigen_tpu_torch import convert
from moviigen_tpu_torch.models import clip as tclip
from moviigen_tpu_torch.ops import flash_attention as tfa
from moviigen_tpu_torch.ops.resize import resize_bicubic

VISION = dict(image_size=16, patch_size=4, dim=32, num_heads=4,
              num_layers=3)
TEXT = dict(vocab_size=64, max_seq_len=24, dim=32, num_heads=4,
            num_layers=2)


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _images(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape) \
        .astype(np.float32)


# ------------------------------------------------------------------ resize


@pytest.mark.parametrize("src,dst", [((480, 832), (224, 224)),
                                     ((40, 56), (224, 224)),
                                     ((64, 64), (64, 64))])
def test_resize_matches_jax_image_resize(src, dst):
    """Down, up and the identity: the same antialiased Keys cubic as
    ``jax.image.resize(method="bicubic")``, within 2e-5 on [-1, 1]."""
    x = _images((2, 3, *src), sum(src))
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3, *dst),
                                       method="bicubic"))
    got = resize_bicubic(torch.from_numpy(x), dst).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 2e-5


def test_resize_without_antialias_would_not_match():
    """Why ``antialias=True`` is pinned: PyTorch's default bicubic samples
    a shrinking source sparsely and misses JAX's by O(1)."""
    x = _images((1, 3, 480, 832), 0)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 3, 224, 224),
                                       method="bicubic"))
    plain = F.interpolate(torch.from_numpy(x), size=(224, 224),
                          mode="bicubic", align_corners=False).numpy()
    assert np.abs(plain - want).max() > 0.5
    assert np.abs(resize_bicubic(torch.from_numpy(x), (224, 224)).numpy()
                  - want).max() <= 2e-5


# ------------------------------------------------- fp32 flash attention

_orig_pallas_call = pl.pallas_call


@pytest.mark.parametrize("k_lens", [None, (257, 130)])
def test_fp32_twin_matches_pallas_interpret_at_the_clip_shape(k_lens):
    """The CLIP's attention: fp32, D = 80, L = 257 (2 heads here), the
    Pallas ``_flash_kernel`` in interpret mode against the twin that the
    fp32 CUDA kernel is held to on the card: within 1e-5 of the output's
    scale (two fp32 online softmaxes over other key blocks)."""
    rng = np.random.default_rng(80)
    q, k, v = (rng.standard_normal((2, 257, 2, 80)).astype(np.float32)
               for _ in range(3))
    with mock.patch.object(jfa.pl, "pallas_call",
                           functools.partial(_orig_pallas_call,
                                             interpret=True)):
        want = np.asarray(jfa.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            k_lens=None if k_lens is None else jnp.asarray(k_lens, jnp.int32),
            block_q=128, block_k=128))
    got = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        k_lens=None if k_lens is None else torch.tensor(k_lens)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# ------------------------------------------------------------ the towers


@pytest.fixture(scope="module")
def vision():
    jcfg = jclip.CLIPVisionConfig(**VISION)
    params = _tree(jclip.init_vision_params(jax.random.PRNGKey(3), jcfg))
    model = convert.load_clip_params(
        tclip.CLIPVision(tclip.CLIPVisionConfig(**VISION)), params)
    return jcfg, params, model


@pytest.mark.parametrize("use_31", [True, False])
def test_vision_forward_matches_jax(vision, use_31):
    """The tower on CLIP-normalized input, with num_layers − 1 blocks and
    with all: within 1e-5 of the features' scale."""
    jcfg, params, model = vision
    x = np.random.default_rng(5).standard_normal((2, 3, 16, 16)) \
        .astype(np.float32)
    want = np.asarray(jclip.vision_forward(params, jnp.asarray(x), jcfg,
                                           use_31_block=use_31))
    with torch.no_grad():
        got = model(torch.from_numpy(x), use_31_block=use_31).numpy()
    assert got.shape == want.shape == (2, 17, 32)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_visual_features_match_jax(vision):
    """[-1, 1] frames of another size: the resize, the normalization and
    the 31-block tower."""
    jcfg, params, model = vision
    frames = _images((2, 3, 40, 56), 6)
    want = np.asarray(jclip.visual_features(params, jnp.asarray(frames),
                                            jcfg))
    got = tclip.visual_features(model, torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_params_tree_round_trips(vision):
    _, params, model = vision
    tree = convert.clip_params_tree(model)
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert len(flat_got) == len(flat_want)
    for path, want in flat_want:
        np.testing.assert_array_equal(flat_got[path].numpy(), want)


def _text_params(cfg, seed):
    """A random JAX text tree (the JAX package has no text init): the
    vision blocks' layout with 4 × dim MLPs."""
    rng = np.random.default_rng(seed)
    d, n = cfg.dim, cfg.num_layers

    def randn(*shape, s=0.2):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    def lin(cin, cout):
        return {"kernel": randn(n, cin, cout, s=cin ** -0.5),
                "bias": randn(n, cout, s=0.1)}

    def norm(*lead):
        return {"scale": 1.0 + randn(*lead, d, s=0.1),
                "bias": randn(*lead, d, s=0.1)}

    return {"token_embedding": randn(cfg.vocab_size, d),
            "type_embedding": randn(cfg.type_size, d),
            "pos_embedding": randn(cfg.max_seq_len, d),
            "norm": norm(),
            "blocks": {"norm1": norm(n), "to_qkv": lin(d, 3 * d),
                       "proj": lin(d, d), "norm2": norm(n),
                       "fc1": lin(d, 4 * d), "fc2": lin(4 * d, d)}}


def test_text_forward_matches_jax():
    """XLM-RoBERTa with padded prompts (pad_id 1 at the end, so k_lens
    masks the pad keys and positions restart from pad_id): within 1e-5 of
    the output's scale."""
    jcfg = jclip.XLMRobertaConfig(**TEXT)
    params = _text_params(jcfg, 9)
    model = convert.load_clip_params(
        tclip.XLMRobertaText(tclip.XLMRobertaConfig(**TEXT)), params)
    ids = np.random.default_rng(10).integers(2, TEXT["vocab_size"], (3, 12))
    ids[1, 7:] = jcfg.pad_id
    ids[2, 3:] = jcfg.pad_id
    want = np.asarray(jclip.text_forward(params, jnp.asarray(ids), jcfg))
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    assert got.shape == want.shape == (3, 12, 32)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    tree = convert.clip_params_tree(model)
    np.testing.assert_array_equal(tree["blocks"]["fc1"]["kernel"].numpy(),
                                  params["blocks"]["fc1"]["kernel"])


def reference_clip_state_dict(cfg: dict, seed: int = 0):
    """A random CLIP checkpoint in the reference layout for the vision
    config ``cfg`` (a dict of ``CLIPVisionConfig`` fields): the vision
    tower, its pooling head, ``log_scale`` and some ``textual.*`` keys."""
    d, p, n = cfg["dim"], cfg["patch_size"], cfg["num_layers"]
    mid = int(d * cfg.get("mlp_ratio", 4))
    n_tok = (cfg["image_size"] // p) ** 2 + 1
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen) * 0.2

    sd = {"visual.patch_embedding.weight": randn(d, 3, p, p),
          "visual.cls_embedding": randn(1, 1, d),
          "visual.pos_embedding": randn(1, n_tok, d),
          "visual.pre_norm.weight": 1 + randn(d),
          "visual.pre_norm.bias": randn(d),
          "visual.head": randn(d, 16), "log_scale": randn(()),
          "textual.token_embedding.weight": randn(10, d),
          "textual.blocks.0.attn.q.weight": randn(d, d)}
    for i in range(n):
        pre = f"visual.transformer.{i}."
        for name in ("norm1", "norm2"):
            sd[pre + name + ".weight"] = 1 + randn(d)
            sd[pre + name + ".bias"] = randn(d)
        for name, (cin, cout) in (("attn.to_qkv", (d, 3 * d)),
                                  ("attn.proj", (d, d)),
                                  ("mlp.0", (d, mid)), ("mlp.2", (mid, d))):
            sd[pre + name + ".weight"] = randn(cout, cin) * cin ** -0.5
            sd[pre + name + ".bias"] = randn(cout)
    return sd


def test_checkpoint_loader_matches_jax(tmp_path):
    """A random reference-layout ``.pth`` (vision and ``textual.*`` keys,
    the pooling head) read by both packages: the same parameters; the
    text keys are ignored by both."""
    cfg = dict(VISION, num_layers=2)
    path = tmp_path / "clip.pth"
    torch.save(reference_clip_state_dict(cfg, seed=4), path)
    want = _tree(jclip.load_clip_checkpoint(
        str(path), jclip.CLIPVisionConfig(**cfg)))
    model = tclip.load_clip_checkpoint(str(path),
                                       tclip.CLIPVisionConfig(**cfg))
    got = dict(jax.tree_util.tree_leaves_with_path(
        convert.clip_params_tree(model)))
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert len(got) == len(flat_want)
    for key, value in flat_want:
        np.testing.assert_array_equal(got[key].numpy(), value)
