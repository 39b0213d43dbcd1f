"""Checkpoint-directory serving in the port: ``WanT2V(checkpoint_dir=...)``
over a random t2v-tiny directory in the reference layout (written by the
port's exporters), the quantized caches beside it (written, hit, rebuilt
when a source file changes, shared with the JAX package) and the
prompt-embedding cache."""

import os

import numpy as np
import pytest
import torch

from moviigen_tpu.configs import WAN_CONFIGS as JAX_CONFIGS
from moviigen_tpu.pipelines import WanT2V as JaxWanT2V
from moviigen_tpu.pipelines import text2video as jt2v
from moviigen_tpu_torch.cli import generate as cli
from moviigen_tpu_torch.configs import WAN_CONFIGS
from moviigen_tpu_torch.models import t5 as tt5
from moviigen_tpu_torch.models import vae as tvae
from moviigen_tpu_torch.models import vae_convert, wan_convert
from moviigen_tpu_torch.models.wan_model import WanModel
from moviigen_tpu_torch.ops import quantization as tq
from moviigen_tpu_torch.pipelines import text2video as t2v
from moviigen_tpu_torch.pipelines.text2video import WanT2V

CFGP = WAN_CONFIGS["t2v-tiny"]
GEN = dict(size=(64, 64), frame_num=5, sampling_steps=2, seed=7,
           return_latents=True)


def write_checkpoint_dir(path, seed=0):
    """A random t2v-tiny checkpoint directory: one DiT safetensors shard
    (live head, non-zero biases), the T5 and VAE ``.pth`` state dicts."""
    gen = torch.Generator().manual_seed(seed)
    dit = WanModel(CFGP.model, dtype=torch.float32).init_weights(gen)
    with torch.no_grad():
        for p in dit.parameters():
            if not bool(p.any()):
                p.normal_(0.0, 0.1, generator=gen)
    wan_convert.export_wan_safetensors(
        os.path.join(path, wan_convert.EXPORT_NAME), dit)
    t5 = tt5.T5Encoder(CFGP.t5, dtype=torch.float32).init_weights(gen)
    torch.save(tt5.t5_state_dict(t5), os.path.join(path, CFGP.t5_checkpoint))
    vae = tvae.init_params(CFGP.vae, gen, encoder=True)
    torch.save(vae_convert.vae_state_dict(vae, CFGP.vae),
               os.path.join(path, CFGP.vae_checkpoint))
    return dit, t5, vae


@pytest.fixture
def ckpt(tmp_path):
    return str(tmp_path), write_checkpoint_dir(str(tmp_path))


def test_checkpoint_dir_generate(ckpt):
    """The directory's weights are the ones served (each cast to its
    parameter's dtype: bf16 linears, fp32 islands), and a video comes
    out."""
    path, (dit, t5, vae) = ckpt
    pipe = WanT2V(CFGP, device="cpu", checkpoint_dir=path)
    assert pipe.dit.blocks[0].ffn_fc1.weight.dtype == torch.bfloat16
    assert pipe.dit.head.weight.dtype == torch.float32
    for got, src in ((pipe.dit, dit), (pipe.t5, t5)):
        want = dict(src.named_parameters())
        for name, p in got.named_parameters():
            assert torch.equal(p, want[name].to(p.dtype)), name
    z = torch.randn(1, CFGP.vae.z_dim, 2, 4, 4,
                    generator=torch.Generator().manual_seed(1))
    assert torch.equal(tvae.decode(pipe.vae_params, z, CFGP.vae),
                       tvae.decode(vae, z, CFGP.vae))
    video = pipe.generate("a cat", size=(64, 64), frame_num=5,
                          sampling_steps=2, seed=1)
    assert video.shape == (3, 5, 64, 64) and np.isfinite(video).all()
    assert np.abs(video).max() <= 1.0 and video.std() > 0.01


@pytest.mark.parametrize("quant", ["int8", "int4", "w8a8"])
def test_quantized_cache_written_hit_and_rebuilt(ckpt, monkeypatch, quant):
    path, _ = ckpt
    monkeypatch.setattr(t2v, "_T5_OFFLOAD_BYTES", 0)
    pipe = WanT2V(CFGP, device="cpu", checkpoint_dir=path, quant=quant)
    assert pipe._quant_t5
    lin = pipe.dit.blocks[0].self_attn.q
    assert isinstance(lin, tq.QuantLinear)
    assert (lin.bits, lin.act8) == (4 if quant == "int4" else 8,
                                    quant == "w8a8")
    assert isinstance(pipe.t5.token_embedding, tq.QuantEmbedding)
    assert pipe.t5.blocks[0].fc1.bits == (4 if quant == "int4" else 8)
    dit_cache = os.path.join(path, f"moviigen_quant_dit_{quant}.safetensors")
    t5_cache = os.path.join(path, f"moviigen_quant_t5_{quant}.safetensors")
    meta = tq.read_quantized_metadata(dit_cache)
    assert meta["tag"] == f"dit_{quant}"
    assert wan_convert.EXPORT_NAME in meta["source_fingerprint"]
    assert CFGP.t5_checkpoint in tq.read_quantized_metadata(
        t5_cache)["source_fingerprint"]
    a = pipe.generate("a cat", **GEN)

    # second start: the caches alone (quantizing again would raise)
    def boom(*args, **kwargs):
        raise AssertionError("quantized again despite a fresh cache")

    monkeypatch.setattr(t2v, "quantize_wan_params", boom)
    monkeypatch.setattr(t2v, "quantize_t5_params", boom)
    mtimes = os.path.getmtime(dit_cache), os.path.getmtime(t5_cache)
    pipe2 = WanT2V(CFGP, device="cpu", checkpoint_dir=path, quant=quant)
    np.testing.assert_array_equal(pipe2.generate("a cat", **GEN), a)
    assert mtimes == (os.path.getmtime(dit_cache), os.path.getmtime(t5_cache))
    monkeypatch.undo()
    monkeypatch.setattr(t2v, "_T5_OFFLOAD_BYTES", 0)

    # a re-published source shard: the DiT cache is rebuilt, the T5's kept
    shard = os.path.join(path, wan_convert.EXPORT_NAME)
    st = os.stat(shard)
    os.utime(shard, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    os.utime(dit_cache, ns=(st.st_atime_ns, st.st_mtime_ns - 10 ** 9))
    WanT2V(CFGP, device="cpu", checkpoint_dir=path, quant=quant)
    assert os.path.getmtime(dit_cache) > mtimes[0], "stale cache not rebuilt"
    assert os.path.getmtime(t5_cache) == mtimes[1]
    assert tq.read_quantized_metadata(dit_cache)["source_fingerprint"] \
        != meta["source_fingerprint"]


def test_prompt_embedding_cache(ckpt):
    path, _ = ckpt
    pipe = WanT2V(CFGP, device="cpu", checkpoint_dir=path)
    a = pipe.encode_text(["a cat", "a dog"])
    cache_dir = os.path.join(path, "moviigen_prompt_cache")
    assert len(os.listdir(cache_dir)) == 2

    # a fresh pipeline: a hit on the whole batch skips the encoder
    pipe2 = WanT2V(CFGP, device="cpu", checkpoint_dir=path)
    pipe2._encode_text_uncached = None  # a miss would crash
    pipe2.t5 = None
    b = pipe2.encode_text(["a cat", "a dog"])
    assert b.dtype == a.dtype and torch.equal(a, b)

    # a partial miss falls through to the encoder
    pipe3 = WanT2V(CFGP, device="cpu", checkpoint_dir=path)
    c = pipe3.encode_text(["a cat", "a NEW prompt"])
    assert torch.equal(a[0], c[0]) and len(os.listdir(cache_dir)) == 3

    # switched off: nothing is written; and a quantized T5 has its own keys
    pipe4 = WanT2V(CFGP, device="cpu", checkpoint_dir=path,
                   prompt_cache=False)
    pipe4.encode_text(["another uncached prompt"])
    assert len(os.listdir(cache_dir)) == 3
    assert pipe._prompt_cache_path("a cat") != WanT2V(
        CFGP, device="cpu", checkpoint_dir=path,
        quant="int8")._prompt_cache_path("a cat") or not pipe._quant_t5


def test_port_written_cache_serves_jax(ckpt, monkeypatch):
    """The port quantizes the directory to int4 and writes its caches;
    the JAX package then starts from those files alone (same names, same
    fingerprint; quantizing again would raise) and serves latents close
    to the port's. bf16 compute on both sides from equal int4 weights:
    3e-2 of the latent scale, the bound of the unquantized pipelines'
    test with room for a 4-bit T5's coarser activations.

    (The other direction is held at the file level in
    test_torch_quantization.py: the JAX writer hands its arrays to
    ``safetensors.numpy.save_file`` as they are, and the non-contiguous
    leaves its checkpoint loader makes are stored scrambled by
    safetensors 0.8.0, so a cache JAX wrote from a real checkpoint is no
    oracle.)"""
    import moviigen_tpu.ops.quantization as jq

    path, _ = ckpt
    monkeypatch.setattr(jt2v, "_T5_OFFLOAD_BYTES", 0)
    monkeypatch.setattr(t2v, "_T5_OFFLOAD_BYTES", 0)
    tpipe = WanT2V(CFGP, device="cpu", checkpoint_dir=path, quant="int4",
                   prompt_cache=False)

    def boom(*args, **kwargs):
        raise AssertionError("JAX quantized despite the port's cache")

    monkeypatch.setattr(jq, "quantize_wan_params", boom)
    monkeypatch.setattr(jq, "quantize_t5_params", boom)
    jpipe = JaxWanT2V(config=JAX_CONFIGS["t2v-tiny"], checkpoint_dir=path,
                      quant="int4", prompt_cache=False)
    assert "q4" in jpipe.dit_params["blocks"]["ffn"]["fc1"]
    assert "q8" in jpipe.t5_params["token_embedding"]
    noise = np.random.default_rng(0).standard_normal((4, 2, 8, 8)) \
        .astype(np.float32)
    kw = dict(size=(64, 64), frame_num=5, sampling_steps=2, noise=noise,
              return_latents=True)
    want, got = jpipe.generate("a red fox", **kw), \
        tpipe.generate("a red fox", **kw)
    assert np.abs(want - noise).max() > 0.3
    err = np.abs(got - want).max() / np.abs(want).max()
    print(f"int4 from the port's cache: max err {err:.3e} of the latent scale")
    assert err <= 3e-2


def test_cli_ckpt_dir_with_quant(ckpt, tmp_path):
    path, _ = ckpt
    out = cli.main(["--task", "t2v-tiny", "--device", "cpu", "--size",
                    "832*480", "--frame_num", "1", "--sample_steps", "1",
                    "--base_seed", "3", "--ckpt_dir", path, "--quant", "w8a8",
                    "--save_file", str(tmp_path / "clip.mp4")])
    assert os.path.exists(out)
    assert os.path.exists(os.path.join(
        path, "moviigen_quant_dit_w8a8.safetensors"))
