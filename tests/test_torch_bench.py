"""``bench_torch.py`` on the CPU at t2v-tiny: one JSON line per size with
the keys the benchmark's readers use. The numbers themselves mean
something only on the card."""

import json

import pytest
import torch

import bench_torch
from moviigen_tpu_torch.configs import WAN_CONFIGS

KEYS = {"task", "quant", "size", "frames", "tokens", "cfg", "warmup_steps",
        "timed_steps", "oom", "s_per_step", "step_s", "flops_per_step",
        "flop_count", "mfu", "peak_gib", "t5_s", "decode_s", "dit_park_s",
        "dit_unpark_s", "min_per_clip_50", "init_s", "device"}


def test_bench_writes_one_line_per_size(capsys, tmp_path):
    out = tmp_path / "bench.jsonl"
    assert bench_torch.main([
        "--task", "t2v-tiny", "--device", "cpu", "--size", "128*128,64*64",
        "--frame_num", "5", "--warmup_steps", "1", "--timed_steps", "1",
        "--out", str(out)]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [x["size"] for x in lines] == ["128*128", "64*64"]
    assert out.read_text().count("\n") == 2
    for line in lines:
        assert set(line) == KEYS
        assert line["oom"] is False and line["quant"] == "bf16"
        assert len(line["step_s"]) == 2 and line["s_per_step"] > 0
        assert line["device"]["type"] == "cpu" and line["mfu"] is None
        assert "alloc_conf" in line["device"]
        assert line["min_per_clip_50"] > 50 * line["s_per_step"] / 60
        assert line["dit_park_s"] is None  # under FREE_DIT_DECODE_GIB
    # 128*128 x 5 frames: latent 2 x 16 x 16, patch 1x2x2 -> 128 tokens
    assert lines[0]["tokens"] == 128 and lines[0]["cfg"] == "batched"


def test_dit_flops_counts_the_14b_step():
    """At 32,760 tokens one CFG step of the 14B (two B=1 forwards) is
    about 3.4 PFLOP, half of it the self-attention products."""
    cfg = WAN_CONFIGS["t2v-14B"].model
    total = bench_torch.dit_flops(cfg, 32760, batch=2)
    attn = 2 * cfg.num_layers * 4.0 * 32760 ** 2 * cfg.dim
    assert 3.0e15 < total < 3.7e15
    assert 0.45 < attn / total < 0.6


def test_bench_records_an_oom_on_its_own_line(capsys, monkeypatch):
    """A size that does not fit is a line of its own, with the error and
    the steps done before it; the next size still runs."""
    from moviigen_tpu_torch.pipelines.text2video import WanT2V

    real = WanT2V.generate

    def generate(self, prompt, size, **kw):
        if size == (64, 64):  # fails in the decode, after its steps
            self.timings = {"step_s": [0.5, 0.25]}
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                              "allocate 2.29 GiB.\nmore")
        return real(self, prompt, size=size, **kw)

    monkeypatch.setattr(WanT2V, "generate", generate)
    assert bench_torch.main([
        "--task", "t2v-tiny", "--device", "cpu", "--size", "64*64,128*128",
        "--frame_num", "5", "--warmup_steps", "1", "--timed_steps", "1"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [x["oom"] for x in lines] == [True, False]
    assert lines[0]["error"] == "CUDA out of memory. Tried to allocate 2.29 GiB."
    assert lines[0]["steps_done"] == 2 and lines[0]["step_s"] == [0.5, 0.25]
    assert lines[0]["s_per_step"] == 0.25 and "peak_gib" not in lines[0]


def test_bench_records_the_dit_parking(capsys, monkeypatch):
    """A size over FREE_DIT_DECODE_GIB parks the DiT for its decode and
    the bench brings it back right after: its line has ``dit_park_s`` and
    ``dit_unpark_s``, both counted in the clip's minutes; the size after
    it finds the DiT resident and has neither."""
    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.pipelines import text2video as t2v

    vae = WAN_CONFIGS["t2v-tiny"].vae
    monkeypatch.setattr(t2v, "FREE_DIT_DECODE_GIB",
                        t2v.decode_gib((4, 2, 16, 16), vae))
    assert bench_torch.main([
        "--task", "t2v-tiny", "--device", "cpu", "--size", "160*160,128*128",
        "--frame_num", "5", "--warmup_steps", "0", "--timed_steps", "1"]) == 0
    big, small = [json.loads(x) for x in capsys.readouterr().out.splitlines()
                  if x.startswith("{")]
    assert big["dit_park_s"] >= 0 and big["dit_unpark_s"] >= 0
    assert small["dit_park_s"] is None and small["dit_unpark_s"] is None
    assert big["min_per_clip_50"] == pytest.approx(
        (big["t5_s"] + 50 * big["s_per_step"] + big["decode_s"]
         + big["dit_park_s"] + big["dit_unpark_s"]) / 60)
