#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port (``moviigen_tpu_torch``): seconds
per denoise step of a text-to-video request, and minutes per 50-step clip.

    python3 bench_torch.py                  # t2v-14B bf16, 832*480 x 81
    python3 bench_torch.py --quant w8a8     # the same, W8A8
    python3 bench_torch.py --size 832*480,1280*720,1920*832
    python3 bench_torch.py --task t2v-tiny --device cpu --size 128*128 \\
        --frame_num 5 --timed_steps 1       # a CPU rehearsal

Builds ``WanT2V`` with random weights from ``--seed`` (no checkpoint is
read) and, for each size, answers one request of ``--warmup_steps`` +
``--timed_steps`` UniPC steps through the entry point a user calls
(``WanT2V.generate``: T5 encode, the CFG denoise loop, the VAE decode).
Writes one JSON line per size:

- ``s_per_step``: median of the timed steps' seconds (host clock around
  each step, which ends in a device synchronise), after the warm-up steps;
- ``flops_per_step`` and ``mfu``: the DiT's matmul and attention flops of
  one CFG step (counted below, ``dit_flops``) over ``s_per_step`` and the
  card's dense bf16 peak (989e12, NVIDIA's H100 SXM data sheet), for W8A8
  too; null off the card;
- ``peak_gib``: ``torch.cuda.max_memory_allocated`` over the request, the
  resident models included;
- ``t5_s``, ``decode_s``, ``dit_park_s``, ``dit_unpark_s`` and
  ``min_per_clip_50``: (t5_s + 50 · s_per_step + dit_park_s + decode_s +
  dit_unpark_s) / 60, a 50-step clip extrapolated from this run.
  ``dit_park_s`` is the time to move the DiT to host memory before a
  decode over the pipeline's ``FREE_DIT_DECODE_GIB`` and
  ``dit_unpark_s`` the time to bring it back, which the bench does right
  after such a request (the next request would pay it): both null for a
  size that does not park;
- the device's name and count, and the card's name and power limit as
  ``nvidia-smi`` gives them.

A size that does not fit is written as such, ``"oom": true`` with the
error's first line and the denoise steps done before it (their seconds,
and their median past the warm-up when there are any), on its own line,
from ``torch.cuda.OutOfMemoryError``; nothing falls back to a smaller
shape. The device entry records ``PYTORCH_CUDA_ALLOC_CONF`` (the
allocator's settings decide what fragments). ``--out`` appends the lines to a
file as well.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

PEAK_BF16_FLOPS = 989e12
PROMPT = ("Two anthropomorphic cats in comfy boxing gear and bright gloves "
          "fight intensely on a spotlighted stage.")
CLIP_STEPS = 50


def dit_flops(cfg, tokens: int, batch: int = 1) -> float:
    """Flops of one DiT forward: per block the self-attention's q, k, v, o
    projections (8·L·d²) and its two products (4·L²·d), the
    cross-attention's q and o projections (4·L·d²), its k and v over the
    text tokens (4·Lt·d²) and its two products (4·L·Lt·d), and the FFN
    (4·L·d·f); the patch embedding, time embedding and head (under 0.1 %
    at 14B) are left out."""
    d, f, lt, n = cfg.dim, cfg.ffn_dim, cfg.text_len, cfg.num_layers
    per_block = (12.0 * tokens * d * d + 4.0 * tokens * tokens * d
                 + 4.0 * lt * d * d + 4.0 * tokens * lt * d
                 + 4.0 * tokens * d * f)
    return batch * n * per_block


def run_size(pipe, config, size, args):
    """One request at ``size`` (W, H): the JSON line of this run."""
    import torch

    from moviigen_tpu_torch.pipelines.text2video import (
        cfg_batched, compute_target_shape_and_seq_len)

    _, tokens, _ = compute_target_shape_and_seq_len(config, size,
                                                    args.frame_num)
    batched = cfg_batched(config.model.dim, tokens)
    line = dict(task=args.task, quant=args.quant or "bf16",
                size=f"{size[0]}*{size[1]}", frames=args.frame_num,
                tokens=tokens, cfg="batched" if batched else "sequential",
                warmup_steps=args.warmup_steps, timed_steps=args.timed_steps)
    cuda = pipe.device.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    steps = args.warmup_steps + args.timed_steps
    try:
        pipe.generate(PROMPT, size=size, frame_num=args.frame_num,
                      sampling_steps=steps, seed=args.seed)
    except torch.cuda.OutOfMemoryError as e:
        # the steps that ran before the failure are still a reading
        done = pipe.timings["step_s"]
        timed = done[args.warmup_steps:]
        line.update(oom=True, error=str(e).splitlines()[0][:300],
                    steps_done=len(done), step_s=done,
                    s_per_step=statistics.median(timed) if timed else None)
        return line
    t = pipe.timings
    pipe.unpark_dit()  # adds dit_unpark_s to t when the decode parked
    s_step = statistics.median(t["step_s"][args.warmup_steps:])
    flops = dit_flops(config.model, tokens, batch=2)  # cond + uncond
    line.update(
        oom=False, s_per_step=s_step, step_s=t["step_s"],
        flops_per_step=flops,
        flop_count="DiT linears + attention products of one CFG step "
                   "(bench_torch.dit_flops, batch 2)",
        mfu=flops / s_step / PEAK_BF16_FLOPS if cuda else None,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30 if cuda else None,
        t5_s=t["t5_s"], decode_s=t["decode_s"],
        dit_park_s=t.get("dit_park_s"), dit_unpark_s=t.get("dit_unpark_s"),
        min_per_clip_50=(t["t5_s"] + CLIP_STEPS * s_step + t["decode_s"]
                         + t.get("dit_park_s", 0.0)
                         + t.get("dit_unpark_s", 0.0)) / 60)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", default="t2v-14B")
    ap.add_argument("--quant", default=None,
                    choices=["int8", "int4", "w8a8"])
    ap.add_argument("--size", default="832*480",
                    help="W*H, or several separated by commas")
    ap.add_argument("--frame_num", type=int, default=81)
    ap.add_argument("--warmup_steps", type=int, default=1)
    ap.add_argument("--timed_steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    ap.add_argument("--out", default=None, help="also append lines here")
    args = ap.parse_args(argv)
    if args.timed_steps < 1 or args.warmup_steps < 0:
        ap.error("--timed_steps must be >= 1 and --warmup_steps >= 0")
    sizes = [tuple(int(v) for v in s.split("*"))
             for s in args.size.split(",")]

    import torch

    from moviigen_tpu_torch import kernels
    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.pipelines.text2video import WanT2V

    config = WAN_CONFIGS[args.task]
    t0 = time.perf_counter()
    pipe = WanT2V(config, device=args.device, quant=args.quant)
    if pipe.device.type == "cuda":
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cuda = pipe.device.type == "cuda"
    device = dict(type=pipe.device.type,
                  name=torch.cuda.get_device_name(0) if cuda else "cpu",
                  count=torch.cuda.device_count() if cuda else 0,
                  card=kernels.card_line() if cuda else None,
                  alloc_conf=os.environ.get("PYTORCH_CUDA_ALLOC_CONF"))
    for size in sizes:
        line = run_size(pipe, config, size, args)
        line.update(init_s=init_s, device=device)
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
