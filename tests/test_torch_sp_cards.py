"""The across-card tools in their CPU mode (gloo ranks, t2v-tiny) and the
trainer's exact resume that their run T5 holds on four cards.

- ``tools/sp_serve_cards.py`` over 2 ranks: the one-card references,
  S0 (one card with its keys rolled), then S1 (Ulysses with the
  per-block gathers), S6 on its pipeline, S8 (i2v-tiny, its timed
  request on its pipeline), S7 (a second request shape in both
  layouts), S2 (the ring) and S5 (int4 and W8A8), each held to its
  gate;
- ``tools/sp_train_cards.py`` over 2 ranks, its library launch: T3 (the
  ring, and USP with a ring of 2) against the one-card step;
- ``cli.finetune`` stopped and resumed takes the steps the run without a
  stop takes: the same data, the same noise, the same bits.

This file imports neither JAX nor the JAX package."""

import json
import pathlib
import subprocess
import sys

import torch

from test_torch_sp_training_dist import _write_dataset

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOOL_TIMEOUT_S = 240


def _tool(name, *args):
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / name),
                           "--device", "cpu", "--task", "t2v-tiny",
                           "--ranks", "2", *map(str, args)],
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=TOOL_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]


def test_serve_tool_cpu_two_ranks(tmp_path):
    rows = {r.get("run"): r for r in _tool(
        "sp_serve_cards.py", "--runs", "S0,S1,S6,S8,S7,S2,S5", "--size",
        "128*128", "--frame_num", 5, "--sample_steps", 2, "--s6_size",
        "128*128", "--s6_frame_num", 5, "--s6_timed", 1, "--i2v_task",
        "i2v-tiny", "--small_clip", "--s7_size", "192*128",
        "--s7_frame_num", 5, "--s8_size", "128*128", "--s8_frame_num", 5,
        "--out_dir", tmp_path)}
    assert {"S0", "S1", "S6", "S8", "S8_timed", "S7_ulysses", "S7_ring",
            "S2", "S5_int4", "S5_w8a8"} <= set(rows)
    for run in ("S1", "S8", "S7_ulysses", "S5_int4", "S5_w8a8"):
        assert rows[run]["ok"] and rows[run]["latent_bit_equal"] \
            and rows[run]["video_bit_equal"], rows[run]
        assert rows[run]["mesh"] == {"data": 1, "seq": 2}
        # a live head: a zero one predicts 0 whatever the blocks do
        assert rows[run]["pred_max_abs"] > 0
    assert rows["S8"]["cond_same_as_one_card"] is True
    assert rows["S8"]["task"] == "i2v-tiny"
    for run in ("S2", "S7_ring"):
        assert rows[run]["sp_mode"] == "ring" and rows[run]["ok"]
        assert rows[run]["pred_max_abs"] > 0
    # 128 tokens over 2 ranks are one key tile and an empty shard: the
    # ring walks them as one card's twin does, bit for bit; 192 tokens
    # are two tiles on the ring and one 512-key block of the twin on one
    # card, so there the blocks' difference reaches the output
    assert rows["S2"]["latent_bit_equal"]
    assert 0 < rows["S7_ring"]["latent_rel_err"] <= 5e-3
    assert rows["S7_ring"]["tokens"] == 192
    # one card against itself with its keys rolled: a difference, no gate
    assert rows["S0"]["ok"] and 0 < rows["S0"]["latent_rel_err"]
    for run, shape in (("S6", [3, 5, 128, 128]),
                       ("S8_timed", [3, 5, 128, 128])):
        r = rows[run]
        assert r["ok"] and r["video_shape"] == shape
        assert -1.0 <= r["video_min"] < r["video_max"] <= 1.0
    assert rows["S8_timed"]["clip_s"] > 0 and rows["S8_timed"]["encode_s"] > 0


def test_train_tool_cpu_two_ranks(tmp_path):
    rows = _tool("sp_train_cards.py", "--runs", "T3", "--latent",
                 "4,2,8,8", "--out_dir", tmp_path)
    assert [(r["run"], r["sp_mode"], r["mesh"]) for r in rows] == [
        ("T3", "ring", {"data": 1, "seq": 2}),
        ("T3", "usp", {"data": 1, "ring": 2, "seq": 1})]
    for r in rows:
        assert r["ok"] and r["max_grad_rel_err"] <= 2e-2, r
        assert r["loss_rel_err"] <= 5e-3
        assert r["tensors"] > 0 and r["sharded_tensors"] > 0


def test_finetune_resume_takes_the_steps_it_would_have_taken(tmp_path):
    """8 steps of 2 items (12 items: past the first epoch) with a
    checkpoint at step 7, then a resume from it: the resumed step 8 reads
    the batch and draws the noise and timestep of the run's step 8, so its
    loss and the final checkpoint are the same bits. (Resumed from the
    first batch with fresh draws, as before, step 8's loss differed.)"""
    from moviigen_tpu_torch.cli import finetune
    from moviigen_tpu_torch.training.data import (
        LatentDataset, SPAwareAspectRatioLengthBucketDistributedSampler)

    sys.modules["torch.utils.tensorboard"] = None  # TensorFlow: seconds
    data = _write_dataset(tmp_path)
    argv = ["--task", "t2v-tiny", "--device", "cpu", "--data_json_path",
            data, "--num_latent_t", "2", "--learning_rate", "1e-3",
            "--train_batch_size", "2", "--max_train_steps", "8"]
    whole = finetune.main(argv + ["--checkpointing_steps", "7",
                                  "--output_dir", str(tmp_path / "a")])
    resumed = finetune.main(argv + [
        "--checkpointing_steps", "100", "--output_dir", str(tmp_path / "b"),
        "--resume_from_checkpoint", str(tmp_path / "a" / "checkpoint-step_7")])
    assert resumed["loss"] == whole["loss"][-1:]
    for file in ("params.safetensors", "opt_state.safetensors"):
        assert (tmp_path / "a" / "checkpoint-step_8" / file).read_bytes() \
            == (tmp_path / "b" / "checkpoint-step_8" / file).read_bytes()
    # the resume crossed into the second epoch
    ds = LatentDataset(data, 2, txt_max_len=16, text_dim=32, seed=42)
    sampler = SPAwareAspectRatioLengthBucketDistributedSampler(
        batch_size=2, dataset_size=len(ds), rank=0, world_size=1, sp_size=1,
        lengths=ds.lengths, aspect_ratios=list(ds.aspect_ratios), seed=42)
    assert finetune._loader_position(sampler, 2, 7)[0] == 1
    assert torch.equal(whole["model"].head.weight,
                       resumed["model"].head.weight)
