"""The port's ``WanT2V`` end to end against the JAX ``WanT2V`` on t2v-tiny,
the port's CLI, and the device rule of the entry points.

Both pipelines hold the same weights (the JAX random init, carried across
by ``convert``, with a random non-zero head so the DiT shapes the result),
read the same prompts through the same tokenizer (the hash fallback; its
ids agree within one process) and start from the same injected noise."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moviigen_tpu.configs import WAN_CONFIGS as JAX_CONFIGS
from moviigen_tpu.pipelines import WanT2V as JaxWanT2V
from moviigen_tpu_torch import convert
from moviigen_tpu_torch.cli import generate as cli
from moviigen_tpu_torch.configs import WAN_CONFIGS
from moviigen_tpu_torch.pipelines import text2video as t2v
from moviigen_tpu_torch.pipelines.text2video import WanT2V

NOISE = np.random.default_rng(0).standard_normal((4, 2, 8, 8)) \
    .astype(np.float32)


@pytest.fixture(scope="module")
def pipes():
    jpipe = JaxWanT2V(config=JAX_CONFIGS["t2v-tiny"], checkpoint_dir=None)
    head = jpipe.dit_params["head"]["head"]
    head["kernel"] = jnp.asarray(np.random.default_rng(1).standard_normal(
        head["kernel"].shape) * 0.1, jnp.float32)
    tpipe = WanT2V(WAN_CONFIGS["t2v-tiny"], device="cpu")

    def tree(t):
        return jax.tree_util.tree_map(np.asarray, t)

    convert.load_wan_params(tpipe.dit, tree(jpipe.dit_params))
    convert.load_t5_params(tpipe.t5, tree(jpipe.t5_params))
    tpipe.vae_params = convert.vae_params_to_torch(tree(jpipe.vae_params))
    return jpipe, tpipe


@pytest.mark.parametrize("solver", ["unipc", "dpm++"])
def test_latents_match_jax(pipes, solver):
    """Final latents after 3 steps. Both pipelines run the DiT and the T5
    in bf16 (the JAX pipeline passes no compute_dtype), with other
    accumulation orders, so bf16 roundings (2^-8 of the value) land
    differently; 1e-2 of the latent scale bounds that with ~3x margin."""
    jpipe, tpipe = pipes
    kw = dict(size=(64, 64), frame_num=5, sampling_steps=3, noise=NOISE,
              return_latents=True, sample_solver=solver)
    want = jpipe.generate("a red fox", **kw)
    got = tpipe.generate("a red fox", **kw)
    assert got.shape == want.shape == NOISE.shape
    assert np.abs(want - NOISE).max() > 1.0  # the sampler moved the latent
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


def test_video_matches_jax(pipes):
    """Decoded video (bf16 decode on both sides): the latent differences
    above plus bf16 rounding in ~30 decoder convs; on the [-1, 1] scale
    the frames agree to 0.15 at worst and 0.02 on average."""
    jpipe, tpipe = pipes
    kw = dict(size=(64, 64), frame_num=5, sampling_steps=2, noise=NOISE)
    want = jpipe.generate("a red fox", **kw)
    got = tpipe.generate("a red fox", **kw)
    assert got.shape == want.shape == (3, 5, 64, 64)
    assert np.all(np.isfinite(got)) and np.abs(got).max() <= 1.0
    diff = np.abs(got - want)
    assert diff.max() < 0.15 and diff.mean() < 0.02
    assert set(tpipe.timings) == {"t5_s", "step_s", "decode_s"}
    assert len(tpipe.timings["step_s"]) == 2


def test_cli_writes_a_file(tmp_path):
    out = cli.main(["--task", "t2v-tiny", "--device", "cpu", "--size",
                    "832*480", "--frame_num", "1", "--sample_steps", "1",
                    "--base_seed", "3",
                    "--save_file", str(tmp_path / "clip.mp4")])
    assert out is not None and os.path.exists(out)


@pytest.mark.parametrize("flag", [["--ring_size", "2"],
                                  ["--ulysses_size", "2"],
                                  ["--t5_fsdp"], ["--dit_fsdp"]])
def test_cli_refuses_later_slice_flags(flag):
    with pytest.raises(NotImplementedError, match="slice"):
        cli.main(["--task", "t2v-tiny", "--device", "cpu", *flag])


def test_no_cuda_device_raises_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WanT2V(WAN_CONFIGS["t2v-tiny"])
    with pytest.raises(RuntimeError, match="CUDA"):
        t2v.resolve_device("cuda")
    assert t2v.resolve_device("cpu") == torch.device("cpu")


def test_cfg_batching_rule():
    """The JAX rule (text2video.py:604) at 14B: the 7,800-token request
    batches the CFG pair, the 18,720-token one runs it sequentially."""
    dim = WAN_CONFIGS["t2v-14B"].model.dim
    assert t2v.cfg_batched(dim, 7800) and not t2v.cfg_batched(dim, 18720)
    shape, seq_len, grid = t2v.compute_target_shape_and_seq_len(
        WAN_CONFIGS["t2v-14B"], (832, 480), 45)
    assert (shape, seq_len, grid) == ((16, 12, 60, 104), 18720, (12, 30, 52))
