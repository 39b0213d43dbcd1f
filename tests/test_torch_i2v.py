"""The port's image-to-video path against the JAX package's, at i2v-tiny:
the conditioning mask and ``build_i2v_conditioning``, the i2v DiT (fp32,
bf16, quantized, the batched CFG pair), the key census and exporter,
``WanI2V.generate``, and both CLIs (``generate --image``, ``preprocess
--dataset i2v``).

The i2v DiT takes 257 CLIP tokens of width 1280 (``img_emb`` and the
cross-attention's split are fixed to ViT-H/14's output), so where a whole
pipeline runs, both packages' ``CLIPVisionConfig`` is patched at run time
to a tower of that output with one block: 16 × 16 patches of one pixel,
16 heads of 80, MLP ratio 1. Weights come from the JAX init (the DiT with
a random non-zero head) and cross through ``convert``; inputs and noise
are numpy from a seed."""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from moviigen_tpu.cli import preprocess as jpre
from moviigen_tpu.configs import WAN_CONFIGS as JAX_CONFIGS
from moviigen_tpu.models import clip as jclip
from moviigen_tpu.models import wan_convert as jconv
from moviigen_tpu.models import wan_model as jwan
from moviigen_tpu.ops import quantization as jq
from moviigen_tpu.ops.rope import rope_3d_freqs as jax_rope
from moviigen_tpu.pipelines import image2video as ji2v
from moviigen_tpu_torch import convert
from moviigen_tpu_torch.cli import generate as tgen
from moviigen_tpu_torch.cli import preprocess as tpre
from moviigen_tpu_torch.configs import WAN_CONFIGS
from moviigen_tpu_torch.models import clip as tclip
from moviigen_tpu_torch.models import wan_convert as tconv
from moviigen_tpu_torch.models.wan_model import WanModel
from moviigen_tpu_torch.ops.rope import rope_3d_freqs
from moviigen_tpu_torch.pipelines import image2video as ti2v
from test_torch_checkpoint_dir import write_checkpoint_dir
from test_torch_clip import reference_clip_state_dict
from test_torch_preprocess import CROP, _raw_dataset
from test_torch_vae import _random_tree

JCFG = JAX_CONFIGS["i2v-tiny"].model
CFG = WAN_CONFIGS["i2v-tiny"].model
# ViT-H/14's output (257 tokens of 1280) from a one-block tower
SMALL_CLIP = dict(image_size=16, patch_size=1, mlp_ratio=1, num_layers=2)
NOISE = np.random.default_rng(0).standard_normal((4, 2, 8, 8)) \
    .astype(np.float32)


@pytest.fixture(scope="module")
def small_clip():
    """Both packages' default CLIP config is SMALL_CLIP's tower."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jclip, tclip):
            mp.setattr(mod, "CLIPVisionConfig", functools.partial(
                mod.CLIPVisionConfig, **SMALL_CLIP))
        yield


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def jax_i2v_params(dtype, seed=0):
    """The JAX i2v-tiny DiT with a random non-zero head, as numpy."""
    params = _tree(jwan.init_params(jax.random.PRNGKey(seed), JCFG, dtype))
    rng = np.random.default_rng(seed + 100)
    for name in ("kernel", "bias"):
        leaf = params["head"]["head"][name]
        params["head"]["head"][name] = (
            rng.standard_normal(leaf.shape) * 0.1).astype(leaf.dtype)
    return params


# ------------------------------------------------------------ conditioning


@pytest.mark.parametrize("frames,h,w", [(9, 4, 6), (81, 60, 104)])
def test_mask_equals_jax(frames, h, w):
    want = np.asarray(ji2v.build_i2v_mask(frames, h, w))
    got = ti2v.build_i2v_mask(frames, h, w).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_conditioning_matches_jax():
    """fp32 on both sides: y (the mask, then the VAE latents of the
    resized image and F − 1 zero frames) within the encode tests' 2e-4;
    the CLIP features of the raw image within 1e-5 of their scale."""
    vae = _random_tree(seed=12)
    ccfg = dict(image_size=16, patch_size=4, dim=32, num_heads=4,
                num_layers=3)
    clip = _tree(jclip.init_vision_params(jax.random.PRNGKey(1),
                                          jclip.CLIPVisionConfig(**ccfg)))
    model = convert.load_clip_params(
        tclip.CLIPVision(tclip.CLIPVisionConfig(**ccfg)), clip)
    image = np.random.default_rng(2).uniform(-1, 1, (3, 40, 56)) \
        .astype(np.float32)
    y_want, f_want = ji2v.build_i2v_conditioning(
        vae, clip, jnp.asarray(image), 5, (48, 32),
        JAX_CONFIGS["i2v-tiny"].vae, jclip.CLIPVisionConfig(**ccfg))
    y_got, f_got = ti2v.build_i2v_conditioning(
        convert.vae_params_to_torch(vae), model, torch.from_numpy(image),
        5, (48, 32), WAN_CONFIGS["i2v-tiny"].vae)
    assert y_got.shape == y_want.shape == (8, 2, 4, 6)
    assert y_got.dtype == torch.float32
    np.testing.assert_array_equal(y_got[:4].numpy(), np.asarray(y_want)[:4])
    np.testing.assert_allclose(y_got.numpy(), np.asarray(y_want), atol=2e-4,
                               rtol=2e-4)
    f_want = np.asarray(f_want)
    assert f_got.shape == f_want.shape == (1, 17, 32)
    assert np.abs(f_got.numpy() - f_want).max() \
        <= 1e-5 * np.abs(f_want).max()


# ---------------------------------------------------------------- the DiT


def _inputs(b, seed, fhw=(2, 4, 6)):
    rng = np.random.default_rng(seed)
    f, h, w = fhw
    x = rng.standard_normal((b, 4, f, h, w)).astype(np.float32)
    y = rng.standard_normal((b, CFG.in_dim - 4, f, h, w)).astype(np.float32)
    ctx = rng.standard_normal((b, CFG.text_len, CFG.text_dim)) \
        .astype(np.float32)
    ctx[-1, 9:] = 0.0  # a zero-padded prompt
    clip_fea = rng.standard_normal((b, 257, 1280)).astype(np.float32)
    t = np.array([500.0, 37.0][:b], np.float32)
    return x, t, ctx, clip_fea, y


def _run_both(params, model, cd, seed=0, seq_len=None):
    x, t, ctx, clip_fea, y = _inputs(2, seed)
    grid = (2, 2, 3)
    want = np.asarray(jwan.forward(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), JCFG,
        jax_rope(grid, JCFG.head_dim), seq_len=seq_len,
        compute_dtype=getattr(jnp, cd), attn_backend="xla",
        clip_fea=jnp.asarray(clip_fea), y=jnp.asarray(y)))
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (x, t, ctx)),
                    rope_3d_freqs(grid, CFG.head_dim), seq_len=seq_len,
                    compute_dtype=getattr(torch, cd), attn_backend="plain",
                    clip_fea=torch.from_numpy(clip_fea),
                    y=torch.from_numpy(y)).numpy()
    return got, want


@pytest.fixture(scope="module")
def fp32_pair():
    params = jax_i2v_params(jnp.float32)
    return params, convert.load_wan_params(
        WanModel(CFG, dtype=torch.float32), params)


@pytest.mark.parametrize("seq_len", [None, 16])
def test_i2v_forward_fp32(fp32_pair, seq_len):
    """fp32 params and compute, at the t2v forward's 5e-4; ``seq_len``
    pads the 12 tokens to 16 (masked keys)."""
    params, model = fp32_pair
    got, want = _run_both(params, model, "float32", seq_len=seq_len)
    assert got.shape == want.shape == (2, 4, 2, 4, 6)
    assert np.abs(want).max() > 1e-2  # the head is live
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)


def test_the_image_tokens_shape_the_prediction(fp32_pair):
    """A different image (clip_fea) or first frame (y) moves the output:
    both conditioning paths are live."""
    _, model = fp32_pair
    x, t, ctx, clip_fea, y = (torch.from_numpy(a) for a in _inputs(1, 4))
    rope = rope_3d_freqs((2, 2, 3), CFG.head_dim)
    with torch.no_grad():
        base = model(x, t, ctx, rope, compute_dtype=torch.float32,
                     clip_fea=clip_fea, y=y)
        other_fea = torch.from_numpy(_inputs(1, 6)[3])
        for kw in (dict(clip_fea=other_fea, y=y),
                   dict(clip_fea=clip_fea, y=-y)):
            other = model(x, t, ctx, rope, compute_dtype=torch.float32, **kw)
            assert float((other - base).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="both"):
        model(x, t, ctx, rope, y=y)


def test_i2v_forward_bf16():
    """bf16 params and compute: every bf16 product rounds at other places
    in the two frameworks; 2e-2 of the output scale, as the t2v forward's
    bf16 bound."""
    params = jax_i2v_params(jnp.bfloat16, seed=1)
    model = convert.load_wan_params(WanModel(CFG, dtype=torch.bfloat16),
                                    params)
    got, want = _run_both(params, model, "bfloat16", seed=1)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_batched_cfg_pair_equals_two_single_forwards(fp32_pair):
    """The pipeline's batched CFG pair (clip_fea and y repeated) gives each
    half what a single forward gives (fp32; a batch of 2 may take other
    GEMM blockings, so within 1e-5 of the scale)."""
    _, model = fp32_pair
    x, t, ctx, clip_fea, y = (torch.from_numpy(a) for a in _inputs(2, 5))
    x, t, clip_fea, y = (a[:1].expand(2, *a.shape[1:])
                         for a in (x, t, clip_fea, y))
    rope = rope_3d_freqs((2, 2, 3), CFG.head_dim)
    kw = dict(compute_dtype=torch.float32)
    with torch.no_grad():
        pair = model(x, t, ctx, rope, clip_fea=clip_fea, y=y, **kw)
        for i in range(2):
            one = model(x[:1], t[:1], ctx[i:i + 1], rope, clip_fea=clip_fea[:1],
                        y=y[:1], **kw)
            assert float((pair[i:i + 1] - one).abs().max()) \
                <= 1e-5 * float(one.abs().max())


@functools.lru_cache(maxsize=None)
def _quantized_pair(quant, dtype):
    params = jax_i2v_params(getattr(jnp, dtype), seed=2)
    rng = np.random.default_rng(9)
    for group in ("self_attn", "cross_attn", "ffn"):
        for leaf in params["blocks"][group].values():
            if "bias" in leaf:
                leaf["bias"] = (rng.standard_normal(leaf["bias"].shape)
                                * 0.3).astype(leaf["bias"].dtype)
    tree = jq.quantize_wan_params(params, bits=4 if quant == "int4" else 8,
                                  act8=quant == "w8a8")
    assert "q8" in tree["blocks"]["cross_attn"]["k_img"] \
        or "q4" in tree["blocks"]["cross_attn"]["k_img"]
    return tree, convert.load_wan_params(
        WanModel(CFG, dtype=getattr(torch, dtype), quant=quant), tree)


@pytest.mark.parametrize("quant,cd,bound", [
    ("int8", "float32", None), ("int4", "float32", None),
    ("int8", "bfloat16", 3e-2), ("w8a8", "float32", 2e-2),
    ("w8a8", "bfloat16", 4e-2)])
def test_quantized_i2v_forward_matches_jax(quant, cd, bound):
    """The i2v DiT with its block linears (k_img and v_img included)
    quantized, at tests/test_torch_quant_model.py's bounds: weight-only in
    fp32 at the forward's 5e-4, in bf16 within 3e-2 of the norm; W8A8
    within 2e-2 / 4e-2 of the norm (a flipped activation-code tie moves a
    token by 1/127)."""
    tree, model = _quantized_pair(quant, cd)
    from moviigen_tpu_torch.ops.quantization import QuantLinear

    assert isinstance(model.blocks[0].cross_attn.v_img, QuantLinear)
    got, want = _run_both(tree, model, cd, seed=3)
    if bound is None:
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)
    else:
        assert np.linalg.norm(got - want) < bound * np.linalg.norm(want)


# ------------------------------------------------------------ key census


@pytest.mark.parametrize("task", ["i2v-tiny", "i2v-14B"])
def test_key_census_equals_jax(task):
    want = jconv.expected_wan_keys(JAX_CONFIGS[task].model)
    assert tconv.expected_wan_keys(WAN_CONFIGS[task].model) == want
    assert "img_emb.proj.4.bias" in want \
        and "blocks.0.cross_attn.norm_k_img.weight" in want


def test_export_loads_in_jax_strictly_and_back(fp32_pair):
    """The port's i2v-tiny state dict through the JAX converter
    (strict=True) and back into a fresh model: the same parameters."""
    _, model = fp32_pair
    sd = tconv.wan_params_to_state_dict(model)
    tree = jconv.convert_wan_state_dict({k: v.numpy() for k, v in sd.items()},
                                        JCFG, dtype=jnp.float32, strict=True)
    back = convert.load_wan_params(WanModel(CFG, dtype=torch.float32),
                                   _tree(tree))
    again = tconv.load_wan_state_dict(WanModel(CFG, dtype=torch.float32), sd)
    for (name, p), q, r in zip(model.named_parameters(), back.parameters(),
                               again.parameters()):
        assert torch.equal(p, q) and torch.equal(p, r), name


def test_cross_loading_t2v_and_i2v_checkpoints_fails(fp32_pair):
    """As tests/test_key_census.py pins for JAX: a t2v checkpoint does not
    load as i2v (keys missing), an i2v one not as t2v (keys left over)."""
    _, model = fp32_pair
    t2v_cfg = WAN_CONFIGS["t2v-tiny"].model
    t2v_sd = tconv.wan_params_to_state_dict(
        WanModel(t2v_cfg, dtype=torch.float32))
    i2v_sd = tconv.wan_params_to_state_dict(model)
    with pytest.raises(ValueError, match="patch_embedding"):
        tconv.load_wan_state_dict(WanModel(CFG, dtype=torch.float32), t2v_sd)
    t2v_sd["patch_embedding.weight"] = i2v_sd["patch_embedding.weight"]
    with pytest.raises(KeyError, match="k_img"):
        tconv.load_wan_state_dict(WanModel(CFG, dtype=torch.float32), t2v_sd)
    i2v_sd["patch_embedding.weight"] = tconv.wan_params_to_state_dict(
        WanModel(t2v_cfg, dtype=torch.float32))["patch_embedding.weight"]
    with pytest.raises(ValueError, match="not consumed"):
        tconv.load_wan_state_dict(WanModel(t2v_cfg, dtype=torch.float32),
                                  i2v_sd)


# ---------------------------------------------------------------- pipeline


def write_i2v_checkpoint_dir(path, seed=0):
    """A random i2v-tiny checkpoint directory in the reference layout: the
    t2v-tiny directory's umT5 and VAE, an i2v-tiny DiT shard (live head,
    non-zero biases) and a CLIP ``.pth`` of the patched tower."""
    write_checkpoint_dir(path, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    dit = WanModel(CFG, dtype=torch.float32).init_weights(gen)
    with torch.no_grad():
        for p in dit.parameters():
            if not bool(p.any()):
                p.normal_(0.0, 0.1, generator=gen)
    tconv.export_wan_safetensors(os.path.join(path, tconv.EXPORT_NAME), dit)
    torch.save(reference_clip_state_dict(
        dataclasses.asdict(tclip.CLIPVisionConfig()), seed=seed + 2),
        os.path.join(path, tclip.CLIP_CHECKPOINT))


@pytest.fixture(scope="module")
def pipes(small_clip, tmp_path_factory):
    """Both packages' ``WanI2V`` over one checkpoint directory."""
    path = str(tmp_path_factory.mktemp("i2v_ckpt"))
    write_i2v_checkpoint_dir(path)
    jpipe = ji2v.WanI2V(config=JAX_CONFIGS["i2v-tiny"], checkpoint_dir=path)
    tpipe = ti2v.WanI2V(WAN_CONFIGS["i2v-tiny"], device="cpu",
                        checkpoint_dir=path, prompt_cache=False)
    return jpipe, tpipe


IMAGE = np.random.default_rng(7).uniform(-1, 1, (3, 40, 56)) \
    .astype(np.float32)
GEN_KW = dict(size=(64, 64), frame_num=5, sampling_steps=2, noise=NOISE,
              return_latents=True)


def test_generate_matches_jax_in_fp32(pipes):
    """The algorithm, with bf16 rounding out of the way: both DiTs compute
    in fp32 (on their bf16 weights) and read the same prompt embeddings;
    the conditioning is fp32 on both sides. 2 UniPC steps under CFG from
    the same noise: the latents within 1e-5 of their scale (measured
    1.2e-6)."""
    jpipe, tpipe = pipes
    with pytest.MonkeyPatch.context() as mp:
        jpipe._denoise_step_cache.clear()
        mp.setattr(jwan, "forward", functools.partial(
            jwan.forward, compute_dtype=jnp.float32))
        mp.setattr(tpipe.dit, "forward", functools.partial(
            type(tpipe.dit).forward, tpipe.dit, compute_dtype=torch.float32))
        mp.setattr(tpipe, "encode_text", lambda texts: convert.to_torch(
            np.asarray(jpipe.encode_text(texts))))
        want = jpipe.generate("a figure starts to move", IMAGE, **GEN_KW)
        got = tpipe.generate("a figure starts to move", IMAGE, **GEN_KW)
    jpipe._denoise_step_cache.clear()
    assert got.shape == want.shape == NOISE.shape
    assert np.abs(want - NOISE).max() > 0.5  # the sampler moved the latent
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_generate_matches_jax(pipes):
    """As served: the DiT and the umT5 in bf16. Each bf16 product rounds
    at other places in the two frameworks (the DiT's prediction drifts by
    ~2e-3 of its scale, the embeddings by ~1e-2), and CFG multiplies the
    cond − uncond difference by the guide scale 5: the latents measured
    7e-3 to 1.05e-2 of their scale apart over 1-3 steps; 2e-2 bounds that,
    and a wrong conditioning moves them by O(1) (the fp32 test above
    holds the algorithm to 1e-5)."""
    jpipe, tpipe = pipes
    want = jpipe.generate("a figure starts to move", IMAGE, **GEN_KW)
    got = tpipe.generate("a figure starts to move", IMAGE, **GEN_KW)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    assert set(tpipe.timings) == {"t5_s", "step_s", "encode_s", "clip_s"}
    video = tpipe.generate("a figure starts to move", IMAGE, size=(64, 64),
                           frame_num=5, sampling_steps=1, noise=NOISE)
    assert video.shape == (3, 5, 64, 64) and np.isfinite(video).all()
    assert np.abs(video).max() <= 1.0


def test_the_checkpoint_directory_is_what_is_served(pipes):
    """The CLIP tower and the i2v DiT read from the directory: the port's
    parameters equal the JAX package's (the DiT's in bf16)."""
    jpipe, tpipe = pipes
    got = dict(jax.tree_util.tree_leaves_with_path(
        convert.clip_params_tree(tpipe.clip)))
    for key, want in jax.tree_util.tree_leaves_with_path(
            _tree(jpipe.clip_params)):
        np.testing.assert_array_equal(got[key].numpy(), want)
    tree = convert.wan_params_tree(tpipe.dit)
    for name in ("fc1", "norm2"):
        for key, want in _tree(jpipe.dit_params["img_emb"][name]).items():
            assert np.array_equal(tree["img_emb"][name][key].float().numpy(),
                                  want.astype(np.float32))


def test_wani2v_needs_an_i2v_config():
    with pytest.raises(ValueError, match="i2v model config"):
        ti2v.WanI2V(WAN_CONFIGS["t2v-tiny"], device="cpu")


# -------------------------------------------------------------------- CLIs


def test_cli_generate_writes_a_video(small_clip, tmp_path):
    img = tmp_path / "cond.png"
    Image.fromarray(np.random.default_rng(0).integers(
        0, 255, (64, 64, 3), dtype=np.uint8)).save(img)
    out = tgen.main(["--task", "i2v-tiny", "--device", "cpu", "--size",
                     "832*480", "--frame_num", "1", "--sample_steps", "1",
                     "--base_seed", "9", "--image", str(img),
                     "--save_file", str(tmp_path / "out.mp4")])
    assert out is not None and os.path.getsize(out) > 0
    with pytest.raises(ValueError, match="--image"):
        tgen.main(["--task", "i2v-tiny", "--device", "cpu", "--size",
                   "832*480", "--frame_num", "1"])


def test_cli_preprocess_i2v_matches_jax(small_clip, tmp_path):
    """Both CLIs with ``--dataset i2v`` over one reference-layout
    directory (the t2v-tiny VAE and umT5, a random CLIP ``.pth`` of the
    patched tower), fp32 encode: the same files and annotation keys, y
    within the encode tests' 2e-4 with the mask exact, the CLIP features
    within 1e-5 of their scale."""
    _, merge_two = _raw_dataset(tmp_path)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    write_checkpoint_dir(str(ckpt))
    cfg = dataclasses.asdict(tclip.CLIPVisionConfig())
    torch.save(reference_clip_state_dict(cfg, seed=3),
               ckpt / tclip.CLIP_CHECKPOINT)
    common = ["--data_merge_path", merge_two, "--task", "i2v-tiny",
              "--dataset", "i2v", "--model_path", str(ckpt),
              "--encode_dtype", "float32", *CROP]
    outs = {}
    for name, main, extra in (("jax", jpre.main, []),
                              ("port", tpre.main, ["--device", "cpu"])):
        out = tmp_path / name
        with open(main(common + extra + ["--output_dir", str(out)])) as f:
            outs[name] = (out, json.load(f))
    (jout, jmeta), (tout, tmeta) = outs["jax"], outs["port"]
    assert len(tmeta) == len(jmeta) == 2
    for g, w in zip(tmeta, jmeta):
        assert g == w and {"y_path", "clip_feature_path"} <= set(g)
    for sub in ("y", "clip_feature"):
        names = sorted(os.listdir(jout / sub))
        assert sorted(os.listdir(tout / sub)) == names and len(names) == 2
        for name in names:
            got, want = np.load(tout / sub / name), np.load(jout / sub / name)
            assert got.dtype == want.dtype == np.float32
            assert got.shape == want.shape
            if sub == "y":
                assert want.shape == (8, 3, 4, 6)
                np.testing.assert_array_equal(got[:4], want[:4])
                np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
            else:
                assert want.shape == (257, 1280)
                assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_finetune_refuses_i2v_naming_why():
    """The JAX trainer feeds neither y nor clip_fea, so there is no i2v
    fine-tuning to port; the port's CLI says so."""
    from moviigen_tpu_torch.cli.finetune import main

    with pytest.raises(NotImplementedError, match="no i2v trainer"):
        main(["--task", "i2v-tiny", "--device", "cpu", "--data_json_path",
              "unused.json"])


def test_bench_runs_an_i2v_request(small_clip, capsys):
    """``bench_torch.py --task i2v-tiny`` on the CPU: one line with the
    conditioning's seconds and minutes per 40-step clip."""
    import bench_torch

    assert bench_torch.main(["--task", "i2v-tiny", "--device", "cpu",
                             "--size", "64*64", "--frame_num", "5",
                             "--timed_steps", "1"]) == 0
    (line,) = [json.loads(x) for x in capsys.readouterr().out.splitlines()
               if x.startswith("{")]
    assert line["task"] == "i2v-tiny" and line["oom"] is False
    assert line["clip_s"] > 0 and line["encode_s"] > 0
    assert "min_per_clip_50" not in line
    assert line["min_per_clip_40"] > 40 * line["s_per_step"] / 60
    assert line["flops_per_step"] > bench_torch.dit_flops(
        WAN_CONFIGS["t2v-tiny"].model, line["tokens"], batch=2)
