#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``moviigen_tpu_torch``) on one
NVIDIA Hopper card.

    python3 chip_smoke.py                 # every phase, as a release check
    python3 chip_smoke.py --phases 1,2    # build + kernel checks only

Phases:
 1. setup: card name and power limit, TF32 off, build the CUDA kernels;
 2. each kernel against its plain PyTorch version on the card, at the
    main path's shapes, with times, bounds and the library yardstick;
 3. the t2v-14B DiT at full width (depth cut) with the kernel against the
    plain attention;
 4. the main path: ``WanT2V`` for t2v-14B at full width and depth
    (random weights) answering two requests, with the kernel's launches
    counted;
 5. (only when asked: ``--phases 5``) a torch.profiler breakdown of one
    full-depth DiT forward at the first request's shape.

Any failure ends the run with a non-zero exit. The last line of standard
output is ``{"ok": true, "device": {...}}``; the line before it lists the
kernels with their measured numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# Main-path shapes at t2v-14B: 832*480, 17 frames -> 7,800 tokens (batched
# CFG, B=2); 45 frames -> 18,720 tokens (sequential CFG, B=1); 81 frames
# (the production 480p clip) -> 32,760 tokens (sequential CFG, B=1).
HEADS, HEAD_DIM = 40, 128
FLASH_CASES = [
    # name, B, Lq, Lk, k_lens as fractions of Lk (None = no mask)
    ("a_self_B2_L7800", 2, 7800, 7800, None),
    ("b_cross_B2_Lq7800_Lk512", 2, 7800, 512, None),
    ("c_klens_B2_L7800", 2, 7800, 7800, (1.0, 0.6)),
    ("d_self_B1_L18720", 1, 18720, 18720, None),
    ("e_self_B1_L32760", 1, 32760, 32760, None),
    ("f_cross_B1_Lq32760_Lk512", 1, 32760, 512, None),
]
# Kernel vs plain, both bf16 out: bf16 keeps 8 mantissa bits (step
# 2^-8 = 3.9e-3 of the value); each side rounds its output once (<= half
# a step) and P is rounded to bf16 relative to a running max that moves
# at different key blocks in the two versions (64-key tiles against
# 512-key blocks), which adds a few more steps' worth that mostly
# average out over thousands of keys. 1e-2 of the output's largest
# magnitude bounds that with margin; a wrong tile, mask or scale is off
# by O(1) of it.
FLASH_REL_TOL = 1e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def flash_bound(b, lq, lk_eff, n=HEADS, d=HEAD_DIM):
    """(bound ms, bound_by): tensor-core flops 4·N·Lq·D per attended key
    against the bytes of q and out once and of k, v once per attended
    key, each over the card's peak."""
    keys = sum(lk_eff)
    flops = 4.0 * n * lq * d * keys
    nbytes = 2.0 * n * d * (2 * b * lq + 2 * keys)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------- phases


def phase_setup(report):
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    report["card"] = smi
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from moviigen_tpu_torch import kernels

    t0 = time.perf_counter()
    secs = kernels.build(["flash_fwd"])
    log(f"phase 1: built kernels {secs} in {time.perf_counter() - t0:.1f} s")
    for name, text in kernels.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")


def phase_kernels(report):
    import torch

    from moviigen_tpu_torch.ops import flash_attention as fa

    cases = []
    for name, b, lq, lk, fracs in FLASH_CASES:
        gen = torch.Generator(device="cuda").manual_seed(len(cases) + 1)
        q = torch.randn(b, lq, HEADS, HEAD_DIM, generator=gen,
                        device="cuda", dtype=torch.bfloat16)
        k = torch.randn(b, lk, HEADS, HEAD_DIM, generator=gen,
                        device="cuda", dtype=torch.bfloat16)
        v = torch.randn(b, lk, HEADS, HEAD_DIM, generator=gen,
                        device="cuda", dtype=torch.bfloat16)
        k_lens = None
        lk_eff = [lk] * b
        if fracs is not None:
            lk_eff = [int(f * lk) for f in fracs]
            k_lens = torch.tensor(lk_eff, dtype=torch.int32, device="cuda")
        got = fa.flash_attention_cuda(q, k, v, k_lens)
        want = fa.flash_attention_plain(q, k, v, k_lens)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"flash {name}: non-finite kernel output")
        err = (got.float() - want.float()).abs()
        max_abs = float(err.max())
        scale_ref = float(want.float().abs().max())
        rel = max_abs / scale_ref
        ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, k_lens))
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, k_lens),
                           iters=10, warmup=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = None
        if k_lens is not None:
            mask = (torch.arange(lk, device="cuda")[None, :]
                    < k_lens[:, None])[:, None, None, :]
        lib_ms = cuda_ms(lambda: torch.nn.functional
                         .scaled_dot_product_attention(qt, kt, vt,
                                                       attn_mask=mask))
        bound_ms, bound_by = flash_bound(b, lq, lk_eff)
        row = dict(case=name, B=b, Lq=lq, Lk=lk, k_lens=lk_eff,
                   max_abs_err=max_abs, rel_err=rel,
                   mean_abs_err=float(err.mean()), ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                   bound_share=bound_ms / ms)
        log("phase 2: flash " + json.dumps(row))
        if rel > FLASH_REL_TOL:
            raise RuntimeError(
                f"flash {name}: kernel vs plain max abs err {max_abs:.3e} "
                f"is {rel:.3e} of max|plain| {scale_ref:.3e} > "
                f"{FLASH_REL_TOL}")
        cases.append(row)
        del q, k, v, got, want, err
        torch.cuda.empty_cache()
    report["flash_cases"] = cases


def kernels_line(report):
    cases = report["flash_cases"]
    main = cases[0]
    return {"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "moviigen_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "moviigen_tpu/ops/flash_attention.py:124",
        "launches": report.get("launches", 0),
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "cases": cases,
    }]}


# DiT kernel path vs plain path (phase 3), bf16 compute, 2 blocks: the
# two attention versions differ by bf16 rounding (see FLASH_REL_TOL), and
# every later bf16 matmul rounds again; the norm-relative difference of
# the prediction stays near 2^-8 per rounding site. 3e-2 bounds that with
# margin; a broken attention changes the prediction by O(1) of its norm.
DIT_REL_TOL = 3e-2
DIT_SMOKE_LAYERS = 2
PROMPT = ("Two anthropomorphic cats in comfy boxing gear and bright gloves "
          "fight intensely on a spotlighted stage.")
# (name, frames, steps, solver): 832*480 at 17 frames is 7,800 tokens
# (batched CFG, full VAE decode); at 45 frames 18,720 tokens (sequential
# CFG by the JAX rule, streaming decode above 2**24 output pixels).
REQUESTS = [
    ("r1_832x480_17f_unipc4", 17, 4, "unipc"),
    ("r2_832x480_45f_dpm2", 45, 2, "dpm++"),
]


def phase_dit(report):
    import torch

    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.models.wan_model import WanModel
    from moviigen_tpu_torch.ops.rope import rope_3d_freqs

    cfg = WAN_CONFIGS["t2v-14B"].model.replace(num_layers=DIT_SMOKE_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = WanModel(cfg, dtype=torch.bfloat16, device="cuda")
    model.init_weights(gen)
    with torch.no_grad():
        model.head.weight.normal_(0.0, 0.02, generator=gen)  # live head
        x = torch.randn(2, cfg.in_dim, 5, 60, 104, generator=gen,
                        device="cuda")
        t = torch.full((2,), 500.0, device="cuda")
        ctx = torch.randn(2, cfg.text_len, cfg.text_dim, generator=gen,
                          device="cuda")
        rope = rope_3d_freqs((5, 30, 52), cfg.head_dim, device="cuda")
        outs = {}
        for backend in ("auto", "plain"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[backend] = model(x, t, ctx, rope, seq_len=7800,
                                  attn_backend=backend)
            torch.cuda.synchronize()
            log(f"phase 3: DiT {DIT_SMOKE_LAYERS} blocks, 7,800 tokens, "
                f"B=2, attn={backend}: {time.perf_counter() - t0:.3f} s "
                "(first call)")
    got, want = outs["auto"].float(), outs["plain"].float()
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError("DiT: non-finite prediction with the kernel")
    rel = float((got - want).norm() / want.norm())
    max_rel = float((got - want).abs().max() / want.abs().max())
    row = dict(layers=DIT_SMOKE_LAYERS, tokens=7800, rel_norm_err=rel,
               rel_max_err=max_rel, pred_norm=float(want.norm()))
    log("phase 3: dit " + json.dumps(row))
    if rel > DIT_REL_TOL:
        raise RuntimeError(f"DiT kernel vs plain: relative error {rel:.3e} "
                           f"> {DIT_REL_TOL}")
    report["dit"] = row
    del model, outs, got, want
    torch.cuda.empty_cache()


def phase_main_path(report):
    import pathlib

    import torch

    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.ops import flash_attention as fa
    from moviigen_tpu_torch.pipelines.text2video import (
        WanT2V, cfg_batched, compute_target_shape_and_seq_len)
    from moviigen_tpu_torch.utils.io import cache_video

    config = WAN_CONFIGS["t2v-14B"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = WanT2V(config, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"phase 4: WanT2V t2v-14B init {init_s:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    out_dir = pathlib.Path(__file__).resolve().parent / "_smoke_out"
    out_dir.mkdir(exist_ok=True)
    rows = []
    total_launches = 0
    for name, frames, steps, solver in REQUESTS:
        _, seq_len, _ = compute_target_shape_and_seq_len(
            config, (832, 480), frames)
        forwards = 1 if cfg_batched(config.model.dim, seq_len) else 2
        expected = steps * forwards * 2 * config.model.num_layers
        torch.cuda.reset_peak_memory_stats()
        fa.flash_attention.launches = 0
        t0 = time.perf_counter()
        video = pipe.generate(PROMPT, size=(832, 480), frame_num=frames,
                              sampling_steps=steps, sample_solver=solver,
                              seed=42)
        total_s = time.perf_counter() - t0
        launches = fa.flash_attention.launches
        total_launches += launches
        if video.shape != (3, frames, 480, 832):
            raise RuntimeError(f"{name}: video shape {video.shape}")
        if not np.isfinite(video).all():
            raise RuntimeError(f"{name}: non-finite video")
        if video.min() < -1.0 or video.max() > 1.0:
            raise RuntimeError(f"{name}: video outside [-1, 1]")
        if launches != expected:
            raise RuntimeError(f"{name}: flash kernel launched {launches} "
                               f"times, expected {expected}")
        path = cache_video(video, save_file=str(out_dir / f"{name}.mp4"),
                           fps=config.sample_fps)
        if path is None or not os.path.exists(path):
            raise RuntimeError(f"{name}: cache_video wrote nothing")
        row = dict(request=name, tokens=seq_len, steps=steps, solver=solver,
                   cfg="batched" if forwards == 1 else "sequential",
                   init_s=init_s, t5_s=pipe.timings["t5_s"],
                   step_s=pipe.timings["step_s"],
                   decode_s=pipe.timings["decode_s"], total_s=total_s,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   launches=launches, expected_launches=expected,
                   video_std=float(video.std()), saved=path)
        log("phase 4: " + json.dumps(row))
        rows.append(row)
    report["requests"] = rows
    report["launches"] = total_launches
    del pipe
    torch.cuda.empty_cache()


def _kernel_category(name: str) -> str:
    if "flash_fwd" in name:
        return "flash_fwd (this port's kernel)"
    low = name.lower()
    if any(tag in low for tag in ("gemm", "xmma", "cutlass", "nvjet",
                                  "matmul")):
        return "GEMM (cuBLAS)"
    if "conv" in low:
        return "convolution (cuDNN)"
    return "elementwise / reduction / copy"


def phase_profile(report):
    """One DiT forward of the full t2v-14B (40 blocks) at the first
    request's shape (7,800 tokens, B=2 batched CFG) under torch.profiler:
    device time by kernel and by category, and the device's idle share
    against the host clock. Not in the default phases."""
    import torch
    from torch.autograd import DeviceType

    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.models.wan_model import WanModel
    from moviigen_tpu_torch.ops.rope import rope_3d_freqs

    cfg = WAN_CONFIGS["t2v-14B"].model
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = WanModel(cfg, dtype=torch.bfloat16, device="cuda")
    model.init_weights(gen)
    with torch.no_grad():
        x = torch.randn(2, cfg.in_dim, 5, 60, 104, generator=gen,
                        device="cuda")
        t = torch.full((2,), 500.0, device="cuda")
        ctx = torch.randn(2, cfg.text_len, cfg.text_dim, generator=gen,
                          device="cuda")
        rope = rope_3d_freqs((5, 30, 52), cfg.head_dim, device="cuda")

        def fwd():
            return model(x, t, ctx, rope, seq_len=7800)

        fwd()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fwd()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        fwd()
        torch.cuda.synchronize()
        wall_ms_unprofiled = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((e.key, us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    cats, launches = {}, {}
    for name, ms, count in rows:
        cat = _kernel_category(name)
        cats[cat] = cats.get(cat, 0.0) + ms
        launches[cat] = launches.get(cat, 0) + count
    summary = dict(
        shape="t2v-14B 40 blocks, 7,800 tokens, B=2, bf16",
        wall_ms=wall_ms, wall_ms_unprofiled=wall_ms_unprofiled,
        device_ms=device_ms,
        idle_share=(1.0 - device_ms / wall_ms) if rows else None,
        categories_ms=cats, categories_launches=launches)
    log("phase 5: profile " + json.dumps(summary))
    for name, ms, count in rows:
        log(f"  {ms:10.3f} ms  x{count:<5d} {name[:110]}")
    report["profile"] = summary
    del model
    torch.cuda.empty_cache()


PHASES = {1: phase_setup, 2: phase_kernels, 3: phase_dit,
          4: phase_main_path, 5: phase_profile}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="1,2,3,4",
                    help="comma-separated phases to run (default: all)")
    args = ap.parse_args(argv)
    phases = sorted({int(p) for p in args.phases.split(",")})

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    import moviigen_tpu_torch  # noqa: F401  (fails outside the repo)

    report = {}
    t_all = time.perf_counter()
    phase_setup(report)
    for p in phases:
        if p != 1:
            PHASES[p](report)
    log(f"total {time.perf_counter() - t_all:.1f} s")
    if "flash_cases" in report:
        print(json.dumps(kernels_line(report)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
