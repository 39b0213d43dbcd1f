"""The check fails what it must fail. Whole tiny runs on the CPU (the look
for a card skipped), with the timed path broken underneath in each of the
ways a one-card cell can be broken, each seen to come out not correct;
and the controls, seen to read well above the sound program."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import core, finetune, serve

SEED = 3_000_000_019
# The tiny cells' own limits (the cells' limits hold at their sizes, not
# at t2v-tiny's): well above what the sound program reads here (latent
# 0.3 %, video 1.5 %; loss 0.02 %, gradient 0.3 %, change 2 %).
LIMITS = {"tiny.serve": {"text_rel": 0.02, "latent_rel": 0.02,
                         "video_rel": 0.05},
          "tiny.ft": {"loss_rel": 0.002, "grad_leaf_gap": 0.03,
                      "change_leaf_gap": 0.2}}


@pytest.fixture(scope="module")
def bench(tiny_root):
    for cell, lims in LIMITS.items():
        (tiny_root / "benchmark" / "limits" / f"{cell}.json").write_text(
            json.dumps({"limits": {k: {"limit": v}
                                   for k, v in lims.items()}}))
    return core.Bench(tiny_root)


def _serve(bench, **kw):
    return serve.run(bench, bench.cell("tiny.serve"), SEED, 0.01, False,
                     "cpu", **kw)


def _train(bench, **kw):
    return finetune.run(bench, bench.cell("tiny.ft"), SEED, 0.01, False,
                        "cpu", **kw)


def test_sound_runs_are_correct(bench):
    assert _serve(bench)["correct"]
    assert _train(bench)["correct"]


def test_serving_step_that_returns_its_state_unchanged(bench, monkeypatch):
    from moviigen_tpu_torch.diffusion import FlowUniPCMultistepScheduler

    monkeypatch.setattr(FlowUniPCMultistepScheduler, "step",
                        lambda self, out, i, sample, state: (sample, state))
    assert not _serve(bench)["correct"]


def test_half_of_the_cfg_batch_left_out(bench, monkeypatch):
    """The batched pair's second half not computed: the first's output
    stands for both (the mean over the rows that are left)."""
    from moviigen_tpu_torch.models.wan_model import WanModel

    orig = WanModel.forward

    def half(self, x, t, context, *a, **kw):
        if x.shape[0] != 2:
            return orig(self, x, t, context, *a, **kw)
        out = orig(self, x[:1], t[:1], context[:1], *a, **kw)
        return out.mean(0, keepdim=True).expand(2, *out.shape[1:])

    monkeypatch.setattr(WanModel, "forward", half)
    assert not _serve(bench)["correct"]


def test_a_token_altered_where_the_dit_produces_it(bench, monkeypatch):
    from moviigen_tpu_torch.models.wan_model import WanModel

    orig = WanModel.forward

    def altered(self, *a, **kw):
        out = orig(self, *a, **kw).clone()
        out[:, :, 0, 0, 0] += 1.0
        return out

    monkeypatch.setattr(WanModel, "forward", altered)
    res = _serve(bench)
    assert not res["correct"]


def test_a_frame_altered_where_the_decode_produces_it(bench, monkeypatch):
    from moviigen_tpu_torch.pipelines import text2video

    orig = text2video.decode_video

    def altered(*a, **kw):
        video = orig(*a, **kw).clone()
        video[:, :, 1] = video[:, :, 1] * 0.8
        return video

    monkeypatch.setattr(text2video, "decode_video", altered)
    res = _serve(bench)
    assert res["checks"]["latent_rel"][0] < LIMITS["tiny.serve"]["latent_rel"]
    assert not res["correct"]


def test_a_clip_cut_short_where_the_decode_produces_it(bench, monkeypatch):
    """The decode's last chunk left out: the frames that are there are
    right, the clip is not."""
    from moviigen_tpu_torch.pipelines import text2video

    orig = text2video.decode_video

    def short(*a, **kw):
        return orig(*a, **kw)[:, :, :-4]

    monkeypatch.setattr(text2video, "decode_video", short)
    res = _serve(bench)
    assert res["checks"]["video_rel"][0] == float("inf")
    assert not res["correct"]


def test_training_step_that_leaves_its_state_unchanged(bench, monkeypatch):
    from moviigen_tpu_torch.training.train_step import AdamW

    monkeypatch.setattr(AdamW, "_update", lambda self, grads, norm: None)
    res = _train(bench)
    assert res["checks"]["change_leaf_gap"][0] == pytest.approx(1.0)
    assert not res["correct"]


def test_training_prediction_altered_where_produced(bench, monkeypatch):
    from moviigen_tpu_torch.models.wan_model import WanModel

    orig = WanModel.forward

    def altered(self, *a, **kw):
        out = orig(self, *a, **kw)
        bump = torch.zeros_like(out)
        bump[:, :, 0, 0, 0] = 1.0
        return out + bump

    monkeypatch.setattr(WanModel, "forward", altered)
    assert not _train(bench)["correct"]


def test_the_controls_read_far_above_the_sound_program(bench):
    """Each control judged as the run judges the program, by the cell's
    limits (``core.judge``), comes out not correct. At these widths int8
    rows of 96 values round finely: W8A8 reads 2-3× bf16 here (the cells'
    ratios are in PERF.md), under the latent's limit; the fp8 encoder and
    decode fail theirs."""
    for cell, run in (("tiny.serve", _serve), ("tiny.ft", _train)):
        res = run(bench, control=True)
        sound = {k: v for k, (v, _) in res["checks"].items()}
        assert res["correct"], res["checks"]
        checks, correct = core.judge(res["control"], bench.limits(cell))
        assert not correct, (cell, checks)
        if cell == "tiny.serve":
            assert res["control"]["latent_rel"] > 2 * sound["latent_rel"]
            assert res["control"]["video_rel"] > 3 * sound["video_rel"]
        else:
            for k in ("loss_rel", "grad_leaf_gap"):
                assert res["control"][k] > 3 * sound[k], (k, sound, checks)
