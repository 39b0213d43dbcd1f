#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``moviigen_tpu_torch``) on one
NVIDIA Hopper card.

    python3 chip_smoke.py                 # every phase, as a release check
    python3 chip_smoke.py --phases 1,2    # build + kernel checks only

Phases:
 1. setup: card name and power limit, TF32 off, build the CUDA kernels
    (``flash_fwd``, ``flash_bwd``, ``int8_gemm``, ``quantize_act`` and
    ``flash_fwd_f32``, and
    the earlier ``mma.sync`` designs of the forward and of the int8 GEMM
    as their yardsticks, one ``nvcc`` each, in parallel);
 2. each kernel against its plain PyTorch version on the card, at the
    shapes of the serving (the i2v image cross-attention's 257 keys
    included), the CLIP's fp32 attention, the training and the W8A8 path,
    with times,
    bounds and the library yardsticks (the forward, its stats variant and
    the int8 GEMM also beside their design before the Hopper redesign, and
    with SM clock and power under load at the main shapes);
 3. the t2v-14B DiT at full width (depth cut) with the kernel against the
    plain attention; then quantized: W8A8 through the int8 GEMM and the
    activation-quantization kernels against their plain versions, int8
    and int4 against the same weights dequantized into plain linears;
 4. the serving path: ``WanT2V`` for t2v-14B at full width and depth
    (random weights) answering two requests, with the forward kernel's
    launches counted;
 5. (only when asked: ``--phases 5``) a torch.profiler breakdown of one
    full-depth DiT forward at the first request's shape;
 6. the training path: (a) the gradients of a 2-block t2v-1.3B at full
    width and 32,760 tokens through the kernels against the plain
    attention; (b) ``cli.finetune`` taking 3 full fine-tune steps of
    t2v-1.3B at full width and depth (a random checkpoint exported and
    loaded back, a synthetic latent dataset) with the stats-forward,
    dKV and dQ launches counted, and its final checkpoint read back;
 7. (only when asked: ``--phases 7``) a torch.profiler breakdown of one
    full-depth t2v-1.3B fine-tune step at 32,760 tokens;
 8. quantized serving: (a) ``WanT2V(quant="w8a8")`` for t2v-14B at full
    width and depth answering the first request, with the int8 GEMM's and
    the activation quantization's launches counted; (b) ``cli.generate
    --ckpt_dir --quant int8`` twice over a random checkpoint directory at
    full width (depth cut), the second start from the quantized caches;
 9. (only when asked: ``--phases 9``) a torch.profiler breakdown of one
    full-depth W8A8 DiT forward at the first request's shape;
10. the preprocessing path: (a) ``cli.preprocess`` at its defaults on 3
    synthetic 1920×832×81 ``.npy`` clips with the full Wan VAE and
    umT5-XXL (random weights), then resumed; (b) the streaming encode
    against the full-tensor encode in fp32; (c) ``cli.preprocess_stages``
    vae + text on the same clips, equal to (a); (d) one 832×480 clip
    preprocessed and ``cli.finetune`` taking a t2v-1.3B step on the port's
    own caches; (e) the t2v-14B pipeline's decode of a 1920×832×81 latent
    beside the DiT and of a 1920×1072×81 one with the DiT parked in host
    memory, then a request with it back;
11. the LoRA path: (k) the stats forward, dKV and dQ kernels at the 14B's
    width (40 heads) and 32,760 tokens, against their plain twins and
    SDPA; (a) ``cli.finetune --task t2v-14B --use_lora --quant int8
    --gradient_checkpointing --export_safetensors``, 3 QLoRA steps at full
    width and depth and 32,760 tokens, launches counted, every adapter
    moved and the base bit-equal, the adapter-only checkpoint and the peft
    export read back; (b) the adapter gradients of a 2-block 14B over an
    int8 base through the kernels against the plain attention; (c) the
    2-block W8A8 14B DiT with adapters, kernel path against plain, and
    detached back to the base bit for bit; (d) ``cli.finetune --task
    t2v-1.3B --use_lora --compute_ot --train_batch_size 2``, the card's
    OT permutation against a float64 brute force on the host; (e)
    ``cli.valid_training --once`` rendering with (a)'s adapters on a 14B
    base;
12. the i2v path: (a) the fp32 ViT-H/14 CLIP tower (31 blocks) through
    the fp32 kernel against plain attention; (b) the i2v-14B DiT at full
    width (2 blocks) with y and clip_fea, kernel path against plain, then
    W8A8 against the plain int8 GEMM; (c) ``cli.generate --task i2v-14B
    --image`` at full width and depth, one 832×480×17 request in 4 steps,
    launches counted; (d) ``cli.preprocess --dataset i2v`` on one
    synthetic 832×480×81 clip.

Any failure ends the run with a non-zero exit. The last line of standard
output is ``{"ok": true, "device": {...}}``; the line before it lists the
kernels with their measured numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np

DEVICE = "cuda"
# The flash forward's design before its Hopper redesign (mma.sync, cp.async),
# timed through the same wrappers as the "before redesign" yardstick.
FWD_BEFORE = "flash_fwd_mma_sync"
FWD_BEFORE_SOURCE = (pathlib.Path(__file__).resolve().parent / "tools"
                     / f"{FWD_BEFORE}.cu")
# The int8 GEMM's design before its Hopper redesign (mma.sync, cp.async),
# the same kind of yardstick.
GEMM_BEFORE = "int8_gemm_mma_sync"
GEMM_BEFORE_SOURCE = FWD_BEFORE_SOURCE.parent / f"{GEMM_BEFORE}.cu"
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
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
    # the i2v DiT's image cross-attention: 257 CLIP tokens, so the last
    # 128-key tile holds one real key
    ("p_imgcross_B2_Lq7800_Lk257", 2, 7800, 257, None),
]
# The fp32 forward (the CLIP tower's attention) at its shapes: ViT-H/14 at
# one image (257 tokens, 16 heads of 80), and a ragged Lq with k_lens
# inside the last key tile. Both versions are full fp32 (TF32 off) and
# differ only in the order of their sums, a few fp32 ulps of the output's
# scale; 1e-5 of it bounds that, a wrong tile, mask or scale is off by
# O(1).
F32_CASES = [
    # name, B, Lq, Lk, N, D, k_lens (None = no mask)
    ("q_clip_B1_L257_N16_D80", 1, 257, 257, 16, 80, None),
    ("r_klens_B2_Lq200_Lk257_N16_D80", 2, 200, 257, 16, 80, (257, 130)),
]
F32_REL_TOL = 1e-5
# Kernel vs plain, both bf16 out: bf16 keeps 8 mantissa bits (step
# 2^-8 = 3.9e-3 of the value); each side rounds its output once (<= half
# a step) and P is rounded to bf16 relative to a running max that moves
# at different key blocks in the two versions (64-key tiles against
# 512-key blocks), which adds a few more steps' worth that mostly
# average out over thousands of keys. 1e-2 of the output's largest
# magnitude bounds that with margin; a wrong tile, mask or scale is off
# by O(1) of it.
FLASH_REL_TOL = 1e-2

# Training shapes at t2v-1.3B (12 heads x 128): 480*832 at 21 latent
# frames -> 32,760 tokens, the finetune CLI's default; the 512-token text
# cross-attention; B=2 at 7,800 tokens with a key mask; the cross-attention
# at 7,800 queries, where the dKV query loop is split as at 32,760; and a
# ragged shape whose k_lens falls inside a key tile.
TRAIN_HEADS = 12
TRAIN_CASES = [
    # name, kind, B, Lq, Lk, k_lens as fractions of Lk (None = no mask)
    ("g_stats_self_B1_L32760", "stats", 1, 32760, 32760, None),
    ("g2_stats_cross_B1_Lq32760_Lk512", "stats", 1, 32760, 512, None),
    ("h_bwd_self_B1_L32760", "bwd", 1, 32760, 32760, None),
    ("i_bwd_cross_B1_Lq32760_Lk512", "bwd", 1, 32760, 512, None),
    ("j_bwd_klens_B2_L7800", "bwd", 2, 7800, 7800, (1.0, 0.6)),
    ("k_bwd_cross_B1_Lq7800_Lk512", "bwd", 1, 7800, 512, None),
    ("l_bwd_ragged_B2_Lq5000_Lk1000", "bwd", 2, 5000, 1000, (1.0, 0.333)),
]
# Stats forward: out as FLASH_REL_TOL; m and l are fp32 sums of the same
# bf16 products in another order (~1e-6 relative), held to the same bound.
# Backward (dq, dk, dv) against the plain twin: the kernels round P and
# dS to bf16 (8 bits) to feed the tensor cores where the twin keeps fp32,
# and both write bf16. The rounding errors are independent from term to
# term and mostly cancel over the Lq or Lk terms of each sum, so each
# gradient stays within a few bf16 steps (2^-8 = 3.9e-3) of its largest
# magnitude; 2e-2 bounds that, and a wrong fragment, mask or scale is off
# by O(1).
GRAD_REL_TOL = 2e-2

# W8A8 shapes at t2v-14B (dim 5120, ffn 13824): M = B x tokens of the
# first request (2 x 7,800), the 2 x 512 text tokens of the cross k/v,
# the 81-frame clip (32,760) and a ragged M below one row tile.
INT8_CASES = [
    # name, M, K, N
    ("a_attn_M15600_K5120_N5120", 15600, 5120, 5120),
    ("b_ffn1_M15600_K5120_N13824", 15600, 5120, 13824),
    ("c_ffn2_M15600_K13824_N5120", 15600, 13824, 5120),
    ("d_text_M1024_K5120_N5120", 1024, 5120, 5120),
    ("e_ffn1_M32760_K5120_N13824", 32760, 5120, 13824),
    ("f_ragged_M333_K5120_N5120", 333, 5120, 5120),
]
# The int8 GEMM against its plain version: no tolerance. The int32 sum is
# exact in both, and the kernel's epilogue rounds each fp32 operation on
# its own (no fma contraction) exactly as the plain version's eager ops
# do, so every output element must be the same bits, in each bias mode.
INT8_ABS_TOL = 0.0
# The bias modes: (tag, with a bias, bias_after_cast)
BIAS_MODES = [("no_bias", False, False), ("bias", True, False),
              ("bias_after_cast", True, True)]
# The activation quantization at the W8A8 path's shapes (M, K): the
# attention and fc1 inputs of the first request, the fc2 input, the
# attention input of the 81-frame clip, and the text context of the cross
# k/v. The kernel against its plain version: no tolerance either (both
# divisions correctly rounded, round half to even, as in the plain
# version).
QUANT_CASES = [(15600, 5120), (15600, 13824), (32760, 5120), (1024, 5120)]


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


def clocks_under_load(fn, ms, samples=5):
    """(median SM clock in MHz, median power draw in W) as ``nvidia-smi``
    reads them while ``fn`` (``ms`` milliseconds a call) runs back to back
    for about three seconds: whether a kernel runs into the card's power
    limit, and at which clock its share of the peak should be read."""
    import torch

    torch.cuda.synchronize()
    for _ in range(max(int(3000 / ms), samples)):
        fn()
    rows = []
    for _ in range(samples + 1):
        time.sleep(0.3)
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True).stdout.strip().splitlines()[0]
        rows.append(tuple(float(x) for x in out.split(",")))
    torch.cuda.synchronize()
    rows = rows[1:]  # the first reading still averages over the idle card
    return (statistics.median(r[0] for r in rows),
            statistics.median(r[1] for r in rows))


def _bound(flops, nbytes, peak_ops=PEAK_BF16_FLOPS):
    t_ops = flops / peak_ops * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def flash_bound(b, lq, lk_eff, n=HEADS, d=HEAD_DIM):
    """(bound ms, bound_by): tensor-core flops 4·N·Lq·D per attended key
    against the bytes of q and out once and of k, v once per attended
    key, each over the card's peak."""
    keys = sum(lk_eff)
    return _bound(4.0 * n * lq * d * keys,
                  2.0 * n * d * (2 * b * lq + 2 * keys))


def train_bounds(b, lq, lk, lk_eff, n=TRAIN_HEADS, d=HEAD_DIM):
    """(bound ms, bound_by) of the stats forward, the dKV and the dQ
    kernel. Flops per attended key and query row, times N·D: 4 for the
    forward (q·kᵀ, P·v), 8 for dKV (S, dP, dV, dK) and 6 for dQ (S, dP,
    dQ). Bytes: every bf16 input read once (masked keys not at all), the
    fp32 row stats (m, l; and Δ in the backward) and the outputs written
    once."""
    keys = sum(lk_eff)
    rows = b * lq * n * d * 2          # one bf16 [B, Lq, N, D] tensor
    kv = keys * n * d * 2              # one bf16 k or v, attended keys
    stats = b * n * lq * 4             # one fp32 [B, N, Lq] row stat
    grads_kv = 2 * b * lk * n * d * 2  # dk and dv, every key written
    fwd = _bound(4.0 * n * lq * d * keys, 2 * rows + 2 * kv + 2 * stats)
    dkv = _bound(8.0 * n * lq * d * keys,
                 2 * rows + 2 * kv + 3 * stats + grads_kv)
    dq = _bound(6.0 * n * lq * d * keys, 3 * rows + 2 * kv + 3 * stats)
    return fwd, dkv, dq


def rel_err(got, want):
    """(max |got − want|, that over max |want|)."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(float(want.float().abs().max()), 1e-30)


# ---------------------------------------------------------------- phases


def phase_setup(report):
    import torch

    from moviigen_tpu_torch import kernels

    smi = kernels.card_line()
    print(smi, flush=True)
    report["card"] = smi
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    secs = kernels.build(kernels.KERNELS + (FWD_BEFORE, GEMM_BEFORE),
                         {FWD_BEFORE: FWD_BEFORE_SOURCE,
                          GEMM_BEFORE: GEMM_BEFORE_SOURCE})
    log(f"phase 1: built kernels {secs} in {time.perf_counter() - t0:.1f} s")
    for name, text in kernels.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")


@contextlib.contextmanager
def before_redesign(name, source):
    """Inside, the wrappers of kernel ``name`` call its design before the
    Hopper redesign (``source``): the yardstick timed beside the kernel.
    The port itself never calls it."""
    from moviigen_tpu_torch import kernels

    kernels.use(name, source)
    try:
        yield
    finally:
        kernels.use(name)


def forward_before_redesign():
    """The forward wrappers (``flash_attention_cuda``,
    ``flash_attention_stats_cuda``) on the forward's earlier design."""
    return before_redesign("flash_fwd", FWD_BEFORE_SOURCE)


def phase_kernels(report):
    import torch

    from moviigen_tpu_torch.ops import flash_attention as fa

    cases = []
    for name, b, lq, lk, fracs in FLASH_CASES:
        gen = torch.Generator(device=DEVICE).manual_seed(len(cases) + 1)
        q = torch.randn(b, lq, HEADS, HEAD_DIM, generator=gen,
                        device=DEVICE, dtype=torch.bfloat16)
        k = torch.randn(b, lk, HEADS, HEAD_DIM, generator=gen,
                        device=DEVICE, dtype=torch.bfloat16)
        v = torch.randn(b, lk, HEADS, HEAD_DIM, generator=gen,
                        device=DEVICE, dtype=torch.bfloat16)
        k_lens = None
        lk_eff = [lk] * b
        if fracs is not None:
            lk_eff = [int(f * lk) for f in fracs]
            k_lens = torch.tensor(lk_eff, dtype=torch.int32, device=DEVICE)
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
        with forward_before_redesign():
            before_ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v,
                                                                k_lens))
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, k_lens),
                           iters=10, warmup=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = None
        if k_lens is not None:
            mask = (torch.arange(lk, device=DEVICE)[None, :]
                    < k_lens[:, None])[:, None, None, :]
        lib_ms = cuda_ms(lambda: torch.nn.functional
                         .scaled_dot_product_attention(qt, kt, vt,
                                                       attn_mask=mask))
        bound_ms, bound_by = flash_bound(b, lq, lk_eff)
        row = dict(case=name, B=b, Lq=lq, Lk=lk, k_lens=lk_eff,
                   max_abs_err=max_abs, rel_err=rel,
                   mean_abs_err=float(err.mean()), ms=ms,
                   before_redesign_ms=before_ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                   bound_share=bound_ms / ms)
        if name.startswith("a_"):  # the main shape: clocks and power
            row["sm_mhz"], row["power_w"] = clocks_under_load(
                lambda: fa.flash_attention_cuda(q, k, v, k_lens), ms)
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
    f32_kernel_cases(report)
    train_kernel_cases(report)
    int8_kernel_cases(report)


def f32_kernel_cases(report):
    """The fp32 forward (``csrc/flash_fwd_f32.cu``) at the CLIP's shapes
    against its plain twin (TF32 off), with its bound on the card's fp32
    rate and fp32 SDPA as the library yardstick."""
    import torch

    from moviigen_tpu_torch.ops import flash_attention as fa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for i, (name, b, lq, lk, n, d, lens) in enumerate(F32_CASES):
        gen = torch.Generator(device=DEVICE).manual_seed(200 + i)
        q, k, v = (torch.randn(b, l, n, d, generator=gen, device=DEVICE)
                   for l in (lq, lk, lk))
        lk_eff = list(lens) if lens is not None else [lk] * b
        k_lens = None if lens is None else torch.tensor(
            lens, dtype=torch.int32, device=DEVICE)
        got = fa.flash_attention_f32_cuda(q, k, v, k_lens)
        want = fa.flash_attention_plain(q, k, v, k_lens)
        torch.cuda.synchronize()
        max_abs, rel = _check(name, "out", got, want, F32_REL_TOL)
        keys = sum(lk_eff)
        bound_ms, bound_by = _bound(4.0 * n * lq * d * keys,
                                    4.0 * n * d * (2 * b * lq + 2 * keys),
                                    peak_ops=PEAK_FP32_FLOPS)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = None
        if k_lens is not None:
            mask = (torch.arange(lk, device=DEVICE)[None, :]
                    < k_lens[:, None])[:, None, None, :]
        row = dict(case=name, B=b, Lq=lq, Lk=lk, N=n, D=d, k_lens=lk_eff,
                   max_abs_err=max_abs, rel_err=rel,
                   ms=cuda_ms(lambda: fa.flash_attention_f32_cuda(
                       q, k, v, k_lens), iters=50, warmup=5),
                   plain_ms=cuda_ms(lambda: fa.flash_attention_plain(
                       q, k, v, k_lens), iters=50, warmup=5),
                   library_ms=cuda_ms(lambda: sdpa(qt, kt, vt,
                                                   attn_mask=mask),
                                      iters=50, warmup=5),
                   library="SDPA fp32", bound_ms=bound_ms,
                   bound_by=bound_by)
        row["bound_share"] = bound_ms / row["ms"]
        log("phase 2: flash f32 " + json.dumps(row))
        rows.append(row)
    report["f32_cases"] = rows


def _check(name, what, got, want, tol):
    """(max abs err, relative err) of a kernel's output against its plain
    twin's; raises if non-finite or past ``tol``."""
    import torch

    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{name}: non-finite kernel {what}")
    max_abs, rel = rel_err(got, want)
    if rel > tol:
        raise RuntimeError(f"{name}: kernel vs plain {what} max abs err "
                           f"{max_abs:.3e} is {rel:.3e} of max|plain| > {tol}")
    return max_abs, rel


def train_kernel_cases(report, cases=None, heads=TRAIN_HEADS,
                       key="train_cases", phase="2"):
    """The stats forward and the two backward kernels at the training
    shapes (``cases``, default TRAIN_CASES, at ``heads`` heads), each
    against its plain twin on the same inputs; SDPA's forward and backward
    as the library yardstick. Rows land in ``report[key]``."""
    import torch

    from moviigen_tpu_torch.ops import flash_attention as fa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for i, (name, kind, b, lq, lk, fracs) in enumerate(cases or TRAIN_CASES):
        gen = torch.Generator(device=DEVICE).manual_seed(100 + i)
        q, k, v = (torch.randn(b, l, heads, HEAD_DIM, generator=gen,
                               device=DEVICE, dtype=torch.bfloat16)
                   for l in (lq, lk, lk))
        lk_eff, k_lens = [lk] * b, None
        if fracs is not None:
            lk_eff = [int(f * lk) for f in fracs]
            k_lens = torch.tensor(lk_eff, dtype=torch.int32, device=DEVICE)
        (fwd_b, fwd_by), (dkv_b, dkv_by), (dq_b, dq_by) = train_bounds(
            b, lq, lk, lk_eff, n=heads)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        mask = None
        if k_lens is not None:
            mask = (torch.arange(lk, device=DEVICE)[None, :]
                    < k_lens[:, None])[:, None, None, :]
        row = dict(case=name, B=b, Lq=lq, Lk=lk, N=heads, k_lens=lk_eff)
        want = fa.flash_attention_stats_plain(q, k, v, k_lens)
        if kind == "stats":
            got = fa.flash_attention_stats_cuda(q, k, v, k_lens)
            torch.cuda.synchronize()
            errs = [_check(name, what, g, w, FLASH_REL_TOL)
                    for what, g, w in zip(("out", "m", "l"), got, want)]
            with torch.no_grad():
                lib_ms = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask))

            def stats_fwd():
                return fa.flash_attention_stats_cuda(q, k, v, k_lens)

            ms = cuda_ms(stats_fwd)
            with forward_before_redesign():
                before_ms = cuda_ms(stats_fwd)
            row.update(
                kernel="flash_fwd_stats",
                max_abs_err=max(e[0] for e in errs),
                rel_err={w: e[1] for w, e in zip(("out", "m", "l"), errs)},
                ms=ms, before_redesign_ms=before_ms,
                plain_ms=cuda_ms(lambda: fa.flash_attention_stats_plain(
                    q, k, v, k_lens), iters=3, warmup=1),
                library_ms=lib_ms, library="SDPA forward",
                bound_ms=fwd_b, bound_by=fwd_by)
            if name.startswith("g_"):  # the main shape: clocks and power
                row["sm_mhz"], row["power_w"] = clocks_under_load(stats_fwd,
                                                                  ms)
        else:
            out, m, l = want
            do = torch.randn(out.shape, generator=gen, device=DEVICE,
                             dtype=torch.bfloat16)
            ops = fa.bwd_operands(q, k, v, k_lens, out, m, l, do)
            dk, dv = fa.flash_bwd_dkv_cuda(ops)
            dq = fa.flash_bwd_dq_cuda(ops)
            torch.cuda.synchronize()
            wdq, wdk, wdv = fa.flash_bwd_plain(q, k, v, k_lens, out, m, l, do)
            errs = {what: _check(name, what, g, w, GRAD_REL_TOL)
                    for what, g, w in (("dq", dq, wdq), ("dk", dk, wdk),
                                       ("dv", dv, wdv))}
            if k_lens is not None:  # keys past k_lens: exactly zero
                for what, g in (("dk", dk), ("dv", dv)):
                    if bool(g[1, lk_eff[1]:].any()):
                        raise RuntimeError(f"{name}: {what} non-zero past "
                                           "k_lens")
            plain_ms = cuda_ms(lambda: fa.flash_bwd_plain(
                q, k, v, k_lens, out, m, l, do), iters=3, warmup=1)
            ot = sdpa(qt, kt, vt, attn_mask=mask)
            dot = do.transpose(1, 2)
            lib_ms = cuda_ms(lambda: torch.autograd.grad(
                ot, (qt, kt, vt), dot, retain_graph=True))
            row.update(
                dkv_query_splits=fa.dkv_query_splits(b, heads, lq, lk),
                rel_err={w: e[1] for w, e in errs.items()},
                max_abs_err={w: e[0] for w, e in errs.items()},
                dkv_ms=cuda_ms(lambda: fa.flash_bwd_dkv_cuda(ops)),
                dq_ms=cuda_ms(lambda: fa.flash_bwd_dq_cuda(ops)),
                plain_ms=plain_ms,
                library_ms=lib_ms, library="SDPA backward (dq, dk, dv)",
                dkv_bound_ms=dkv_b, dkv_bound_by=dkv_by,
                dq_bound_ms=dq_b, dq_bound_by=dq_by)
            if name.startswith("h_"):  # the main shape: clocks and power
                for key, fn in (("dkv", fa.flash_bwd_dkv_cuda),
                                ("dq", fa.flash_bwd_dq_cuda)):
                    mhz, watts = clocks_under_load(lambda: fn(ops),
                                                   row[f"{key}_ms"])
                    row[f"{key}_sm_mhz"], row[f"{key}_power_w"] = mhz, watts
            # at 12 heads the cross-attention has too few key blocks to
            # fill the card, and the query loop must split (at 40 it need
            # not)
            if ("cross" in name and heads == TRAIN_HEADS
                    and row["dkv_query_splits"] < 2):
                raise RuntimeError(f"{name}: the dKV query loop was not "
                                   "split at a cross-attention shape")
            del ops, dk, dv, dq, wdq, wdk, wdv, ot, do
        log(f"phase {phase}: train " + json.dumps(row))
        rows.append(row)
        del q, k, v, qt, kt, vt, want
        torch.cuda.empty_cache()
    report[key] = rows


def int8_kernel_cases(report):
    """The int8 GEMM at the W8A8 path's shapes, in its three bias modes,
    against its plain version (bit for bit), beside its design before the
    Hopper redesign; then the activation-quantization kernel. Yardsticks
    the port never calls: ``torch._int_mm`` plus the eager rescale (the
    library's route to the same function) and the bf16 ``F.linear`` of
    the same layer (what W8A8 competes with)."""
    import torch
    import torch.nn.functional as F

    from moviigen_tpu_torch.ops import int8_gemm as ig
    from moviigen_tpu_torch.ops.quantization import (dequantize_leaf,
                                                     quantize_activations,
                                                     quantize_linear_int4)

    rows = []
    for i, (name, m, k, n) in enumerate(INT8_CASES):
        gen = torch.Generator(device=DEVICE).manual_seed(200 + i)
        x = torch.randn(m, k, generator=gen, device=DEVICE,
                        dtype=torch.bfloat16)
        xq, sx = quantize_activations(x)
        wq = torch.randint(-127, 128, (n, k), generator=gen, device=DEVICE,
                           dtype=torch.int8)
        sw = torch.full((n,), 0.02 / k ** 0.5, device=DEVICE)
        bias = torch.randn(n, generator=gen, device=DEVICE,
                           dtype=torch.bfloat16)
        errs = {}
        for tag, with_bias, after in BIAS_MODES:
            b = bias if with_bias else None
            got = ig.int8_gemm_fused(xq, wq, sx, sw, b, bias_after_cast=after)
            want = ig.int8_gemm_plain(xq, wq, sx, sw, b, bias_after_cast=after)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise RuntimeError(f"int8 {name} {tag}: non-finite output")
            errs[tag] = float((got.float() - want.float()).abs().max())
            if errs[tag] > INT8_ABS_TOL or not torch.equal(got, want):
                raise RuntimeError(
                    f"int8 {name} {tag}: kernel differs from plain, max abs "
                    f"err {errs[tag]:.3e} (max |plain| "
                    f"{float(want.float().abs().max()):.3e})")
            del got, want
        ops = 2.0 * m * n * k
        nbytes = m * k + n * k + 2 * m * n + 4 * (m + n)
        bound_ms, bound_by = _bound(ops, nbytes, PEAK_INT8_OPS)
        bound_bias_ms, _ = _bound(ops, nbytes + 4 * n, PEAK_INT8_OPS)

        def kernel(b=None, after=False):
            return ig.int8_gemm_fused(xq, wq, sx, sw, b, bias_after_cast=after)

        ms = cuda_ms(kernel)
        ms_bias = cuda_ms(lambda: kernel(bias))
        ms_after = cuda_ms(lambda: kernel(bias, True))
        with before_redesign("int8_gemm", GEMM_BEFORE_SOURCE):
            before_ms = cuda_ms(kernel)
            before_after_ms = cuda_ms(lambda: kernel(bias, True))
        plain_ms = cuda_ms(lambda: ig.int8_gemm_plain(xq, wq, sx, sw),
                           iters=3, warmup=1)
        wt = wq.t()  # [K, N] column-major, the layout _int_mm wants

        def library():
            return (torch._int_mm(xq, wt).float() * sx * sw[None, :]).to(
                torch.bfloat16)

        try:
            same = torch.equal(library(),
                               ig.int8_gemm_plain(xq, wq, sx, sw))
            lib_ms = cuda_ms(library)
            int_mm_ms = cuda_ms(lambda: torch._int_mm(xq, wt))
        except RuntimeError as e:  # a yardstick only: some shapes it refuses
            log(f"phase 2: int8 {name}: torch._int_mm refused: {e}")
            same = lib_ms = int_mm_ms = None
        wb = torch.randn(n, k, generator=gen, device=DEVICE,
                         dtype=torch.bfloat16)
        bf16_ms = cuda_ms(lambda: F.linear(x, wb))
        # what a weight-only linear pays per call before its cuBLAS product
        deq8_ms = cuda_ms(lambda: dequantize_leaf(wq, sw, torch.bfloat16))
        q4, s4 = quantize_linear_int4(wb)
        deq4_ms = cuda_ms(lambda: dequantize_leaf(q4, s4, torch.bfloat16))
        del q4, s4
        row = dict(case=name, M=m, K=k, N=n, max_abs_err=max(errs.values()),
                   max_abs_err_by_mode=errs,
                   ms=ms, ms_bias=ms_bias, ms_bias_after_cast=ms_after,
                   before_redesign_ms=before_ms,
                   before_redesign_bias_after_cast_ms=before_after_ms,
                   plain_ms=plain_ms,
                   library_ms=lib_ms, library="torch._int_mm + eager rescale",
                   library_equal=same, int_mm_only_ms=int_mm_ms,
                   bf16_linear_ms=bf16_ms,
                   dequant_int8_ms=deq8_ms, dequant_int4_ms=deq4_ms,
                   bound_ms=bound_ms, bound_bias_ms=bound_bias_ms,
                   bound_by=bound_by, bound_share=bound_ms / ms,
                   tops=ops / ms / 1e9)
        if name.startswith("b_"):  # the widest shape: clocks and power
            row["sm_mhz"], row["power_w"] = clocks_under_load(kernel, ms)
        log("phase 2: int8 " + json.dumps(row))
        rows.append(row)
        del x, xq, sx, wq, wt, wb
        torch.cuda.empty_cache()
    report["int8_cases"] = rows
    quantize_kernel_cases(report)


def quantize_kernel_cases(report):
    """The activation-quantization kernel at the W8A8 path's shapes
    against its plain version (bit for bit). No single PyTorch call
    computes this function, so there is no library yardstick."""
    import torch

    from moviigen_tpu_torch.ops import quantization as tq

    rows = []
    for i, (m, k) in enumerate(QUANT_CASES):
        gen = torch.Generator(device=DEVICE).manual_seed(300 + i)
        x = torch.randn(m, k, generator=gen, device=DEVICE,
                        dtype=torch.bfloat16)
        x[::7] *= 1e3  # rows at other scales
        x[1::11] = 0.0  # rows at the 1e-8 floor
        got_q, got_s = tq.quantize_activations_cuda(x)
        want_q, want_s = tq.quantize_activations_plain(x)
        torch.cuda.synchronize()
        if not (torch.equal(got_q, want_q) and torch.equal(got_s, want_s)):
            raise RuntimeError(
                f"quantize M={m} K={k}: kernel differs from plain in "
                f"{int((got_q != want_q).sum())} codes and "
                f"{int((got_s != want_s).sum())} scales")
        err = max(float((got_q.float() - want_q.float()).abs().max()),
                  float((got_s - want_s).abs().max()))
        # x read once, xq and sx written once
        bound_ms, bound_by = _bound(8.0 * m * k, 3 * m * k + 4 * m)
        ms = cuda_ms(lambda: tq.quantize_activations_cuda(x))
        row = dict(case=f"quantize_M{m}_K{k}", M=m, K=k, max_abs_err=err,
                   ms=ms, plain_ms=cuda_ms(
                       lambda: tq.quantize_activations_plain(x), iters=5),
                   bound_ms=bound_ms, bound_by=bound_by,
                   bound_share=bound_ms / ms, library_ms=None,
                   library="none: no single PyTorch call computes it")
        log("phase 2: quantize " + json.dumps(row))
        rows.append(row)
        del x, got_q, got_s, want_q, want_s
        torch.cuda.empty_cache()
    report["quantize_cases"] = rows


def kernels_line(report):
    cases = report["flash_cases"]
    main = cases[0]
    entries = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "moviigen_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "moviigen_tpu/ops/flash_attention.py:124",
        "launches": report.get("launches", 0),
        "launches_by_path": {
            "serving r1 + r2 (phase 4)": report.get("launches", 0),
            "watcher render (phase 11e)": report.get("watcher_launches", 0),
            "w8a8 + adapters (phase 11c)": report.get(
                "lora_w8a8_launches", {}).get("launches", 0),
            "i2v request (phase 12c)": report.get("i2v_launches", {}).get(
                "launches", 0)},
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main["ms"],
        "before_redesign_ms": main["before_redesign_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "cases": cases,
    }]
    f32 = report.get("f32_cases")
    if f32:
        main32 = f32[0]  # the CLIP tower's shape
        entries.append({
            "name": "flash_fwd_f32",
            "route": "cuda",
            "source": "moviigen_tpu_torch/csrc/flash_fwd_f32.cu",
            "replaces": "moviigen_tpu/ops/flash_attention.py:124 (fp32)",
            "launches": report.get("i2v_launches", {}).get("f32_launches",
                                                           0),
            "launches_by_path": {
                "i2v request (phase 12c)": report.get(
                    "i2v_launches", {}).get("f32_launches", 0),
                "i2v preprocess (phase 12d)": report.get(
                    "i2v_preprocess_launches", {}).get("f32_launches", 0)},
            "max_abs_err": max(c["max_abs_err"] for c in f32),
            "ms": main32["ms"], "plain_ms": main32["plain_ms"],
            "bound_ms": main32["bound_ms"], "bound_by": main32["bound_by"],
            "library_ms": main32["library_ms"],
            "cases": f32,
        })
    int8 = report.get("int8_cases")
    if int8:
        main8 = int8[0]  # the attention projections of the first request
        entries.append({
            "name": "int8_gemm",
            "route": "cuda",
            "source": "moviigen_tpu_torch/csrc/int8_gemm.cu",
            "replaces": "moviigen_tpu/ops/int8_gemm.py:53",
            "launches": report.get("int8_launches", 0),
            "launches_by_path": {
                "q1 (phase 8a)": report.get("int8_launches", 0),
                "w8a8 + adapters (phase 11c)": report.get(
                    "lora_w8a8_launches", {}).get("int8_gemm_launches", 0),
                "qlora (phase 11a)": report.get("qlora_launches", {}).get(
                    "int8_gemm_launches", 0),
                "i2v w8a8 DiT (phase 12b)": report.get("i2v_dit", {}).get(
                    "w8a8", {}).get("launches", {}).get(
                        "int8_gemm_launches", 0)},
            "max_abs_err": max(c["max_abs_err"] for c in int8),
            "ms": main8["ms"],
            "before_redesign_ms": main8["before_redesign_ms"],
            "plain_ms": main8["plain_ms"],
            "bound_ms": main8["bound_ms"], "bound_by": main8["bound_by"],
            "library_ms": main8["library_ms"],
            "bf16_linear_ms": main8["bf16_linear_ms"],
            "cases": int8,
        })
        quant = report["quantize_cases"]
        mainq = quant[0]  # the attention input of the first request
        entries.append({
            "name": "quantize_act",
            "route": "cuda",
            "source": "moviigen_tpu_torch/csrc/quantize_act.cu",
            "replaces": "moviigen_tpu/ops/quantization.py:81 (XLA, not a "
                        "Pallas kernel)",
            "launches": report.get("quantize_launches", 0),
            "launches_by_path": {
                "q1 (phase 8a)": report.get("quantize_launches", 0),
                "w8a8 + adapters (phase 11c)": report.get(
                    "lora_w8a8_launches", {}).get("quantize_launches", 0),
                "qlora (phase 11a)": report.get("qlora_launches", {}).get(
                    "quantize_launches", 0),
                "i2v w8a8 DiT (phase 12b)": report.get("i2v_dit", {}).get(
                    "w8a8", {}).get("launches", {}).get(
                        "quantize_launches", 0)},
            "max_abs_err": max(c["max_abs_err"] for c in quant),
            "ms": mainq["ms"], "plain_ms": mainq["plain_ms"],
            "bound_ms": mainq["bound_ms"], "bound_by": mainq["bound_by"],
            "library_ms": None, "library": mainq["library"],
            "cases": quant,
        })
    train = report.get("train_cases", []) + report.get("train14_cases", [])
    if not train:
        return {"kernels": entries}
    counts = report.get("train_launches", {})

    def by_path(key):
        return {"ft (phase 6b)": counts.get(key, 0),
                "qlora (phase 11a)": report.get("qlora_launches", {}).get(
                    key, 0),
                "ot (phase 11d)": report.get("ot_launches", {}).get(key, 0)}

    stats = [c for c in train if "kernel" in c]
    bwd = [c for c in train if "kernel" not in c]
    # self-attention at 32,760 tokens: the 1.3B row (N = 12) when phase 2
    # ran, else the 14B one (N = 40)
    s, bmain = stats[0], bwd[0]
    entries.append({
        "name": "flash_fwd_stats",
        "route": "cuda",
        "source": "moviigen_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "moviigen_tpu/ops/flash_attention.py:105",
        "launches": counts.get("stats_launches", 0),
        "launches_by_path": by_path("stats_launches"),
        "max_abs_err": max(c["max_abs_err"] for c in stats),
        "ms": s["ms"], "before_redesign_ms": s["before_redesign_ms"],
        "plain_ms": s["plain_ms"],
        "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
        "library_ms": s["library_ms"], "cases": stats,
    })
    for name, line, key, grads in (
            ("flash_bwd_dkv", 275, "dkv", ("dk", "dv")),
            ("flash_bwd_dq", 326, "dq", ("dq",))):
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "moviigen_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"moviigen_tpu/ops/flash_attention.py:{line}",
            "launches": counts.get(f"{key}_launches", 0),
            "launches_by_path": by_path(f"{key}_launches"),
            "max_abs_err": max(c["max_abs_err"][g] for c in bwd
                               for g in grads),
            "ms": bmain[f"{key}_ms"], "plain_ms": bmain["plain_ms"],
            "bound_ms": bmain[f"{key}_bound_ms"],
            "bound_by": bmain[f"{key}_bound_by"],
            "library_ms": bmain["library_ms"],
            "cases": [{"case": c["case"], "N": c["N"], "ms": c[f"{key}_ms"],
                       "bound_ms": c[f"{key}_bound_ms"],
                       "plain_ms": c["plain_ms"],
                       "library_ms": c["library_ms"],
                       "rel_err": {g: c["rel_err"][g] for g in grads}}
                      for c in bwd],
        })
    return {"kernels": entries}


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
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    model = WanModel(cfg, dtype=torch.bfloat16, device=DEVICE)
    model.init_weights(gen)
    with torch.no_grad():
        model.head.weight.normal_(0.0, 0.02, generator=gen)  # live head
        x = torch.randn(2, cfg.in_dim, 5, 60, 104, generator=gen,
                        device=DEVICE)
        t = torch.full((2,), 500.0, device=DEVICE)
        ctx = torch.randn(2, cfg.text_len, cfg.text_dim, generator=gen,
                          device=DEVICE)
        rope = rope_3d_freqs((5, 30, 52), cfg.head_dim, device=DEVICE)
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
    phase_dit_quant(report)


# Quantized DiT (phase 3), 2 blocks at full width, bf16 compute.
# W8A8, the int8 GEMM and the activation-quantization kernels against
# their plain versions: every GEMM and every quantization is the same bits
# (INT8_ABS_TOL) and the rest of the forward is the same code on the same
# inputs, so the predictions are expected equal; the bound allows for one
# reduction elsewhere taking another order between two runs, which can
# flip a round(x / sx) tie and move one activation code by a step (1/127
# of its token's absmax).
# int8 / int4 weight-only against plain nn.Linears holding the same
# dequantized bf16 weights: the same cuBLAS product on the same values;
# the bound allows for cuBLAS choosing another algorithm for a weight that
# is a temporary.
QUANT_DIT_REL_TOL = 1e-3


@contextlib.contextmanager
def plain_int8_gemm():
    """Inside, the W8A8 linears run the plain versions of the int8 GEMM
    and of the activation quantization on the card (the reference the
    kernel path is held against)."""
    from moviigen_tpu_torch.models import wan_model as wm
    from moviigen_tpu_torch.ops import int8_gemm as ig
    from moviigen_tpu_torch.ops import quantization as tq

    saved = (ig.int8_gemm_fused, wm.int8_gemm_fused, ig.quantize_activations,
             wm.quantize_activations)
    ig.int8_gemm_fused = wm.int8_gemm_fused = ig.int8_gemm_plain
    ig.quantize_activations = wm.quantize_activations = \
        tq.quantize_activations_plain
    try:
        yield
    finally:
        (ig.int8_gemm_fused, wm.int8_gemm_fused, ig.quantize_activations,
         wm.quantize_activations) = saved


def _dit_inputs(cfg, gen):
    """The first request's DiT inputs: B=2 (batched CFG), 7,800 tokens."""
    import torch

    from moviigen_tpu_torch.ops.rope import rope_3d_freqs

    x = torch.randn(2, cfg.in_dim, 5, 60, 104, generator=gen, device=DEVICE)
    t = torch.full((2,), 500.0, device=DEVICE)
    ctx = torch.randn(2, cfg.text_len, cfg.text_dim, generator=gen,
                      device=DEVICE)
    return x, t, ctx, rope_3d_freqs((5, 30, 52), cfg.head_dim, device=DEVICE)


def phase_dit_quant(report):
    import torch

    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.models.wan_model import WanModel
    from moviigen_tpu_torch.ops import int8_gemm as ig
    from moviigen_tpu_torch.ops.quantization import (TARGET_SUFFIXES,
                                                     block_linear,
                                                     dequantize_leaf)

    cfg = WAN_CONFIGS["t2v-14B"].model.replace(num_layers=DIT_SMOKE_LAYERS)
    rows = {}
    for quant in ("w8a8", "int8", "int4"):
        gen = torch.Generator(device=DEVICE).manual_seed(10)
        model = WanModel(cfg, dtype=torch.bfloat16, device=DEVICE,
                         quant=quant).init_weights(gen)
        with torch.no_grad():
            model.head.weight.normal_(0.0, 0.02, generator=gen)  # live head
            for blk in model.blocks:  # non-zero biases: both bias orders
                for suffix in TARGET_SUFFIXES:
                    owner, attr = block_linear(blk, suffix)
                    if hasattr(owner, attr):
                        getattr(owner, attr).bias.normal_(0.0, 0.3,
                                                          generator=gen)
            x, t, ctx, rope = _dit_inputs(cfg, gen)
            ig.reset_launch_counts()
            got = model(x, t, ctx, rope, seq_len=7800).float()
            launches = ig.launch_counts()
            if quant == "w8a8":
                with plain_int8_gemm():
                    want = model(x, t, ctx, rope, seq_len=7800).float()
                if ig.launch_counts() != launches:
                    raise RuntimeError("DiT w8a8: the plain run launched a "
                                       f"kernel: {ig.launch_counts()}")
            else:
                twin = WanModel(cfg, dtype=torch.bfloat16, device=DEVICE)
                params = dict(model.named_parameters())
                for name, p in twin.named_parameters():
                    if name in params:
                        p.copy_(params[name])
                for blk, tblk in zip(model.blocks, twin.blocks):
                    for suffix in TARGET_SUFFIXES:
                        owner, attr = block_linear(blk, suffix)
                        if not hasattr(owner, attr):
                            continue
                        q = getattr(owner, attr)
                        lin = getattr(*block_linear(tblk, suffix))
                        lin.weight.copy_(dequantize_leaf(
                            q.qweight, q.scale, torch.bfloat16))
                        lin.bias.copy_(q.bias)
                want = twin(x, t, ctx, rope, seq_len=7800).float()
                del twin
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"DiT {quant}: non-finite prediction")
        rel = float((got - want).norm() / want.norm())
        # per block: 10 linears through the GEMM, their inputs quantized
        # in 7 groups (q/k/v share one, as do the cross k/v)
        w8a8 = quant == "w8a8"
        expected = dict(int8_gemm_launches=10 * DIT_SMOKE_LAYERS * w8a8,
                        quantize_launches=7 * DIT_SMOKE_LAYERS * w8a8)
        rows[quant] = dict(rel_norm_err=rel,
                           equal=bool(torch.equal(got, want)),
                           pred_norm=float(want.norm()), launches=launches)
        log(f"phase 3: quantized dit {quant} " + json.dumps(rows[quant]))
        if rel > QUANT_DIT_REL_TOL:
            raise RuntimeError(f"DiT {quant}: relative error {rel:.3e} > "
                               f"{QUANT_DIT_REL_TOL}")
        if launches != expected:
            raise RuntimeError(f"DiT {quant}: W8A8 kernels launched "
                               f"{launches}, expected {expected}")
        del model, got, want
        torch.cuda.empty_cache()
    report["dit_quant"] = rows


def phase_main_path(report):
    import pathlib

    import torch

    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.ops import flash_attention as fa
    from moviigen_tpu_torch.ops import int8_gemm as ig
    from moviigen_tpu_torch.pipelines.text2video import (
        WanT2V, cfg_batched, compute_target_shape_and_seq_len)
    from moviigen_tpu_torch.utils.io import cache_video

    config = WAN_CONFIGS["t2v-14B"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = WanT2V(config, device=DEVICE)
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
        fa.reset_launch_counts()
        ig.reset_launch_counts()
        t0 = time.perf_counter()
        video = pipe.generate(PROMPT, size=(832, 480), frame_num=frames,
                              sampling_steps=steps, sample_solver=solver,
                              seed=42)
        total_s = time.perf_counter() - t0
        counts = fa.launch_counts()
        launches = counts.pop("launches")
        if any(counts.values()):  # serving runs under no-grad
            raise RuntimeError(f"{name}: training kernels launched {counts}")
        if any(ig.launch_counts().values()):
            raise RuntimeError(f"{name}: the bf16 path launched W8A8 kernels "
                               f"{ig.launch_counts()}")
        total_launches += launches
        _serve_checks(name, video, frames)
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
    if "int8_gemm" in name:
        return "int8 GEMM (this port's kernel)"
    if "quantize_rows" in name:
        return "activation quantization (this port's kernel)"
    if "flash_bwd_dkv" in name:
        return "flash dKV (this port's kernel)"
    if "flash_bwd_dq" in name:
        return "flash dQ (this port's kernel)"
    if "flash_fwd" in name:  # the stats variant is the template's <true>
        stats = "<true>" in name or "ILb1E" in name
        return (f"flash forward{' stats' if stats else ''} "
                "(this port's kernel)")
    low = name.lower()
    if any(tag in low for tag in ("gemm", "xmma", "cutlass", "nvjet",
                                  "matmul")):
        return "GEMM (cuBLAS)"
    if "conv" in low:
        return "convolution (cuDNN)"
    return "elementwise / reduction / copy"


def profile(fn, label, phase):
    """Run ``fn`` once under torch.profiler (after one warm-up call) and
    once more without it: device time by kernel and by category, and the
    device's idle share against the host clock."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    fn()
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
        shape=label, wall_ms=wall_ms, wall_ms_unprofiled=wall_ms_unprofiled,
        device_ms=device_ms,
        idle_share=(1.0 - device_ms / wall_ms) if rows else None,
        categories_ms=cats, categories_launches=launches)
    log(f"phase {phase}: profile " + json.dumps(summary))
    for name, ms, count in rows[:40]:
        log(f"  {ms:10.3f} ms  x{count:<5d} {name[:110]}")
    return summary


def phase_profile(report):
    """One DiT forward of the full t2v-14B (40 blocks) at the first
    request's shape (7,800 tokens, B=2 batched CFG) under torch.profiler.
    Not in the default phases."""
    import torch

    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.models.wan_model import WanModel
    from moviigen_tpu_torch.ops.rope import rope_3d_freqs

    cfg = WAN_CONFIGS["t2v-14B"].model
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    model = WanModel(cfg, dtype=torch.bfloat16, device=DEVICE)
    model.init_weights(gen)
    with torch.no_grad():
        x = torch.randn(2, cfg.in_dim, 5, 60, 104, generator=gen,
                        device=DEVICE)
        t = torch.full((2,), 500.0, device=DEVICE)
        ctx = torch.randn(2, cfg.text_len, cfg.text_dim, generator=gen,
                          device=DEVICE)
        rope = rope_3d_freqs((5, 30, 52), cfg.head_dim, device=DEVICE)
        report["profile"] = profile(
            lambda: model(x, t, ctx, rope, seq_len=7800),
            "t2v-14B 40 blocks, 7,800 tokens, B=2, bf16", 5)
    del model
    torch.cuda.empty_cache()


# ------------------------------------------------------------- training

# t2v-1.3B fine-tuning at the finetune CLI's defaults: 480*832, 81 frames
# -> latents [16, 21, 60, 104] -> 21 x 30 x 52 = 32,760 tokens, B=1.
TRAIN_TASK = "t2v-1.3B"
TRAIN_LATENT = (16, 21, 60, 104)
TRAIN_STEPS = 3
GRAD_CHECK_LAYERS = 2
PROMPT_LENS = (12, 40, 77, 512)  # tokens of the 4 synthetic prompts
# Gradient of every parameter tensor, kernel path vs plain attention, both
# bf16 compute (norm-relative): the two differ where attention rounds to
# bf16 (the forward's output, as DIT_REL_TOL; the backward's P and dS,
# as GRAD_REL_TOL) and every later bf16 product rounds that again; the
# differences stay near 2^-8 of each gradient's norm. 3e-2 bounds that
# with margin; a gradient cut from the graph is off by 1 (all of it).
PARAM_GRAD_REL_TOL = 3e-2


def _train_inputs(cfg, gen):
    """A random fp32 DiT with a live head (the zero-initialised head
    would make every block gradient exactly zero) and the rope tables of
    the training grid."""
    import torch

    from moviigen_tpu_torch.models.wan_model import WanModel
    from moviigen_tpu_torch.ops.rope import rope_3d_freqs

    model = WanModel(cfg, dtype=torch.float32, device=DEVICE)
    model.init_weights(gen)
    with torch.no_grad():
        model.head.weight.normal_(0.0, 0.02, generator=gen)
    _, f, h, w = TRAIN_LATENT
    grid = (f // cfg.patch_size[0], h // cfg.patch_size[1],
            w // cfg.patch_size[2])
    return model, rope_3d_freqs(grid, cfg.head_dim, device=DEVICE)


def phase_grad_check(report):
    """(a) Gradients of a 2-block t2v-1.3B at full width and 32,760
    tokens through the kernels (``FlashAttention``: stats forward, dKV,
    dQ) against the plain attention, per parameter tensor."""
    import torch

    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.ops import flash_attention as fa

    cfg = WAN_CONFIGS[TRAIN_TASK].model.replace(num_layers=GRAD_CHECK_LAYERS)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    model, rope = _train_inputs(cfg, gen)
    x = torch.randn(1, *TRAIN_LATENT, generator=gen, device=DEVICE)
    t = torch.full((1,), 500.0, device=DEVICE)
    ctx = torch.randn(1, cfg.text_len, cfg.text_dim, generator=gen,
                      device=DEVICE)
    ctx[:, PROMPT_LENS[2]:] = 0.0  # a zero-padded prompt
    target = torch.randn(x.shape, generator=gen, device=DEVICE)
    names, params = zip(*model.named_parameters())
    sites = 2 * GRAD_CHECK_LAYERS  # self + cross attention per block
    want_counts = {
        "auto": dict(dict.fromkeys(fa.COUNTERS, 0), stats_launches=sites,
                     dkv_launches=sites, dq_launches=sites),
        "plain": dict.fromkeys(fa.COUNTERS, 0)}
    grads = {}
    for backend in ("auto", "plain"):
        fa.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = model(x, t, ctx, rope, attn_backend=backend)
        loss = torch.mean(torch.square(pred - target))
        grads[backend] = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        counts = fa.launch_counts()
        log(f"phase 6a: {GRAD_CHECK_LAYERS}-block t2v-1.3B, 32,760 tokens, "
            f"attn={backend}: loss {loss.item():.6f}, forward+backward "
            f"{time.perf_counter() - t0:.3f} s (first call), launches "
            f"{counts}")
        if counts != want_counts[backend]:
            raise RuntimeError(f"grad check attn={backend}: launches "
                               f"{counts}, expected {want_counts[backend]}")
        del pred, loss
    errs = {}
    for name, g, w in zip(names, grads["auto"], grads["plain"]):
        errs[name] = float((g - w).norm() / w.norm().clamp_min(1e-30))
    qkv = [n for n in names
           if re.search(r"\.(self|cross)_attn\.[qkv]\.weight$", n)]
    zero = [n for n in qkv
            if not bool(grads["auto"][names.index(n)].abs().max() > 0)]
    worst = sorted(errs.items(), key=lambda kv: -kv[1])
    row = dict(layers=GRAD_CHECK_LAYERS, tokens=32760,
               tensors=len(errs), qkv_weights=len(qkv),
               max_rel_err=worst[0][1], worst=dict(worst[:6]),
               median_rel_err=statistics.median(errs.values()))
    log("phase 6a: grad check " + json.dumps(row))
    if len(qkv) != 6 * GRAD_CHECK_LAYERS or zero:
        raise RuntimeError(f"grad check: q/k/v projection weights {qkv} "
                           f"have all-zero gradients: {zero}")
    bad = {n: e for n, e in errs.items() if not e <= PARAM_GRAD_REL_TOL}
    if bad:
        raise RuntimeError(f"grad check: kernel vs plain gradient past "
                           f"{PARAM_GRAD_REL_TOL} (norm-relative): {bad}")
    report["grad_check"] = row
    del model, grads
    torch.cuda.empty_cache()


def phase_trainer(report):
    """(b) The training path as a user runs it: ``cli.finetune.main``
    for t2v-1.3B at full width and depth, 3 steps at 32,760 tokens, from
    a random checkpoint exported with the port's
    ``export_wan_safetensors`` and a synthetic latent dataset; every
    training kernel's launches counted; the final checkpoint read back
    and deleted."""
    import pathlib
    import shutil

    import torch

    from moviigen_tpu_torch.cli import finetune
    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.models.wan_convert import (
        EXPORT_NAME, export_wan_safetensors, wan_params_to_state_dict)
    from moviigen_tpu_torch.ops import flash_attention as fa
    from moviigen_tpu_torch.ops import int8_gemm as ig
    from moviigen_tpu_torch.training.checkpoint import OPT_FILE, PARAMS_FILE
    from moviigen_tpu_torch.utils.safetensors import load_file

    root = pathlib.Path(__file__).resolve().parent / "_smoke_out" / "train"
    shutil.rmtree(root, ignore_errors=True)
    ckpt_dir, data_dir, out_dir = root / "ckpt", root / "data", root / "out"
    for d in (ckpt_dir, data_dir / "latent", data_dir / "prompt_embed"):
        d.mkdir(parents=True)
    log(f"phase 6b: {shutil.disk_usage(root).free / 2**30:.1f} GiB free "
        f"under {root}")
    cfg = WAN_CONFIGS[TRAIN_TASK].model
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    model, _ = _train_inputs(cfg, gen)
    n_params = sum(p.numel() for p in model.parameters())
    t0 = time.perf_counter()
    export_wan_safetensors(str(ckpt_dir / EXPORT_NAME), model)
    export_s = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    rng = np.random.default_rng(0)
    annos = []
    for i, n in enumerate(PROMPT_LENS):
        np.save(data_dir / "latent" / f"clip{i}.npy",
                rng.standard_normal(TRAIN_LATENT, dtype=np.float32))
        np.save(data_dir / "prompt_embed" / f"clip{i}.npy",
                rng.standard_normal((n, cfg.text_dim), dtype=np.float32))
        annos.append({"latent_path": f"clip{i}.npy",
                      "prompt_embed_path": f"clip{i}.npy",
                      "length": 81, "aspect_ratio_bin": 0})
    data_json = data_dir / "videos2caption.json"
    data_json.write_text(json.dumps(annos))

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    ig.reset_launch_counts()
    t0 = time.perf_counter()
    record = finetune.main([
        "--task", TRAIN_TASK, "--device", DEVICE,
        "--ckpt_dir", str(ckpt_dir),
        "--data_json_path", str(data_json), "--num_latent_t", "21",
        "--gradient_checkpointing", "--max_train_steps", str(TRAIN_STEPS),
        "--checkpointing_steps", "1000", "--output_dir", str(out_dir),
        "--seed", "0"])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    counts = fa.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    report["train_launches"] = counts
    if any(ig.launch_counts().values()):
        raise RuntimeError(f"trainer: W8A8 kernels launched "
                           f"{ig.launch_counts()}")

    # per step, each of the 2 x 30 attention sites: the stats forward in
    # the forward and again in the per-block recompute, one dKV, one dQ
    sites = 2 * cfg.num_layers
    want = dict(dict.fromkeys(fa.COUNTERS, 0),
                stats_launches=2 * sites * TRAIN_STEPS,
                dkv_launches=sites * TRAIN_STEPS,
                dq_launches=sites * TRAIN_STEPS)
    losses, gnorms = record["loss"], record["grad_norm"]
    log(f"phase 6b: finetune {TRAIN_STEPS} steps in {main_s:.1f} s: loss "
        f"{losses}, grad_norm {gnorms}, step_s {record['step_s']}, "
        f"launches {counts}")
    if record["step"] != TRAIN_STEPS or len(losses) != TRAIN_STEPS:
        raise RuntimeError(f"trainer stopped at step {record['step']}")
    if not (np.isfinite(losses).all() and np.isfinite(gnorms).all()
            and min(gnorms) > 0):
        raise RuntimeError(f"trainer: loss {losses}, grad_norm {gnorms}")
    if counts != want:
        raise RuntimeError(f"trainer: launches {counts}, expected {want}")

    model, opt = record["model"], record["optimizer"]
    initial = load_file(str(ckpt_dir / EXPORT_NAME))
    trained = wan_params_to_state_dict(model)
    same = [k for k in initial if torch.equal(initial[k], trained[k])]
    if same:
        raise RuntimeError(f"trainer: parameters unchanged after "
                           f"{TRAIN_STEPS} steps: {same[:8]}")
    del initial, trained
    path = pathlib.Path(record["checkpoint"])
    ckpt_gib = sum(f.stat().st_size for f in path.iterdir()) / 2**30
    t0 = time.perf_counter()
    saved = load_file(str(path / PARAMS_FILE))
    saved_opt = torch.load(path / OPT_FILE, map_location="cpu",
                           weights_only=True)
    read_s = time.perf_counter() - t0
    for name, p in model.named_parameters():
        if not torch.equal(saved[name], p.detach().cpu()):
            raise RuntimeError(f"checkpoint: {name} read back differs")
    state = opt.state_dict()
    if (saved_opt["count"], saved_opt["mini_step"]) != (state["count"],
                                                        state["mini_step"]):
        raise RuntimeError("checkpoint: optimizer counts read back differ")
    for key in ("m", "v"):
        for a, b in zip(saved_opt[key], state[key]):
            if not torch.equal(a, b.cpu()):
                raise RuntimeError(f"checkpoint: optimizer {key} differs")
    row = dict(task=TRAIN_TASK, layers=cfg.num_layers, tokens=32760,
               params=n_params, steps=TRAIN_STEPS, step_s=record["step_s"],
               step_s_median_2_3=statistics.median(record["step_s"][1:]),
               loss=losses, grad_norm=gnorms, peak_gib=peak_gib,
               checkpoint_gib=ckpt_gib,
               checkpoint_save_s=record["checkpoint_s"],
               checkpoint_read_s=read_s, export_s=export_s,
               launches=counts, expected_launches=want)
    log("phase 6b: trainer " + json.dumps(row))
    report["trainer"] = row
    del record, model, opt, saved, saved_opt
    shutil.rmtree(root)
    torch.cuda.empty_cache()


def phase_train(report):
    phase_grad_check(report)
    phase_trainer(report)


def phase_train_profile(report):
    """One full fine-tune step of t2v-1.3B at 32,760 tokens (per-block
    remat, AdamW) under torch.profiler. Not in the default phases."""
    import torch

    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.training import (TrainConfig, make_optimizer,
                                             make_train_step)

    cfg = WAN_CONFIGS[TRAIN_TASK].model
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    model, rope = _train_inputs(cfg, gen)
    tc = TrainConfig(remat=True)
    step = make_train_step(model, tc, rope,
                           make_optimizer(list(model.parameters()), tc),
                           generator=gen)
    batch = {"latents": torch.randn(1, *TRAIN_LATENT, generator=gen,
                                    device=DEVICE),
             "context": torch.randn(1, cfg.text_len, cfg.text_dim,
                                    generator=gen, device=DEVICE)}
    report["train_profile"] = profile(
        lambda: step(batch),
        "t2v-1.3B fine-tune step, 30 blocks, 32,760 tokens, per-block "
        "remat, fp32 AdamW", 7)
    del model, step
    torch.cuda.empty_cache()


# ---------------------------------------------------- quantized serving

# Phase 8b: a checkpoint directory at t2v-14B's width with the depth cut:
# 2 DiT blocks, and 6 of umT5-XXL's 24 layers, which keeps the encoder's
# bf16 weights (4.4 GB) above the size from which the quant modes
# quantize it too.
CKPT_TASK = "t2v-14B-cut"
CKPT_DIT_LAYERS, CKPT_T5_LAYERS = 2, 6


def _serve_checks(name, video, frames):
    if video.shape != (3, frames, 480, 832):
        raise RuntimeError(f"{name}: video shape {video.shape}")
    if not np.isfinite(video).all():
        raise RuntimeError(f"{name}: non-finite video")
    if video.min() < -1.0 or video.max() > 1.0:
        raise RuntimeError(f"{name}: video outside [-1, 1]")


def phase_quant_serving(report):
    """(a) The W8A8 main path: ``WanT2V(quant="w8a8")`` for t2v-14B at
    full width and depth (random quantized weights) answering the first
    request, every block linear through the int8 GEMM kernel."""
    import torch

    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.ops import flash_attention as fa
    from moviigen_tpu_torch.ops import int8_gemm as ig
    from moviigen_tpu_torch.ops.quantization import QuantLinear
    from moviigen_tpu_torch.pipelines.text2video import WanT2V

    config = WAN_CONFIGS["t2v-14B"]
    name, frames, steps, solver = REQUESTS[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = WanT2V(config, device=DEVICE, quant="w8a8")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gib = torch.cuda.memory_allocated() / 2**30
    linears = [m for m in pipe.dit.modules() if isinstance(m, QuantLinear)]
    if len(linears) != 10 * config.model.num_layers or not all(
            m.act8 for m in linears) or not pipe._quant_t5:
        raise RuntimeError("w8a8: the DiT's block linears or the T5 are not "
                           "quantized")
    fa.reset_launch_counts()
    ig.reset_launch_counts()
    t0 = time.perf_counter()
    video = pipe.generate(PROMPT, size=(832, 480), frame_num=frames,
                          sampling_steps=steps, sample_solver=solver, seed=42)
    total_s = time.perf_counter() - t0
    counts = {**fa.launch_counts(), **ig.launch_counts()}
    # one batched-CFG forward per step: 10 block linears, their inputs
    # quantized in 7 groups, and 2 attention sites in each of the 40
    # blocks (400 GEMM and 280 quantize launches per forward)
    want = dict.fromkeys(counts, 0)
    want["int8_gemm_launches"] = 10 * config.model.num_layers * steps
    want["quantize_launches"] = 7 * config.model.num_layers * steps
    want["launches"] = 2 * config.model.num_layers * steps
    _serve_checks(name, video, frames)
    if counts != want:
        raise RuntimeError(f"w8a8 {name}: launches {counts}, expected {want}")
    row = dict(request=name, quant="w8a8", tokens=7800, steps=steps,
               init_s=init_s, weights_gib=weights_gib,
               t5_s=pipe.timings["t5_s"], step_s=pipe.timings["step_s"],
               decode_s=pipe.timings["decode_s"], total_s=total_s,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=counts, video_std=float(video.std()))
    log("phase 8a: " + json.dumps(row))
    report["w8a8_request"] = row
    report["int8_launches"] = counts["int8_gemm_launches"]
    report["quantize_launches"] = counts["quantize_launches"]
    del pipe
    torch.cuda.empty_cache()
    phase_ckpt_dir_serving(report)


def phase_ckpt_dir_serving(report):
    """(b) ``cli.generate --ckpt_dir --quant int8`` as a user runs it,
    twice, over a random checkpoint directory in the reference layout
    that the port's exporters write first: the first start quantizes and
    writes the caches, the second must start from them alone."""
    import pathlib
    import shutil

    import torch

    from moviigen_tpu_torch import configs
    from moviigen_tpu_torch.cli import generate
    from moviigen_tpu_torch.models import t5 as t5m
    from moviigen_tpu_torch.models import vae as vaem
    from moviigen_tpu_torch.models import vae_convert, wan_convert
    from moviigen_tpu_torch.models.wan_model import WanModel
    from moviigen_tpu_torch.ops import flash_attention as fa
    from moviigen_tpu_torch.ops import int8_gemm as ig
    from moviigen_tpu_torch.ops.quantization import quantize_linear
    from moviigen_tpu_torch.pipelines import text2video as t2v

    base = configs.WAN_CONFIGS["t2v-14B"]
    cfg = base.replace(
        name=CKPT_TASK,
        model=base.model.replace(num_layers=CKPT_DIT_LAYERS),
        t5=base.t5.replace(num_layers=CKPT_T5_LAYERS))
    configs.WAN_CONFIGS[CKPT_TASK] = cfg
    configs.SUPPORTED_SIZES[CKPT_TASK] = configs.SUPPORTED_SIZES["t2v-14B"]
    root = pathlib.Path(__file__).resolve().parent / "_smoke_out" / "serve"
    shutil.rmtree(root, ignore_errors=True)
    ckpt = root / "ckpt"
    ckpt.mkdir(parents=True)

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    t0 = time.perf_counter()
    dit = WanModel(cfg.model, dtype=torch.float32, device=DEVICE)
    dit.init_weights(gen)
    wan_convert.export_wan_safetensors(str(ckpt / wan_convert.EXPORT_NAME),
                                       dit)
    fc1 = dit.blocks[0].ffn_fc1.weight.detach().to(torch.bfloat16)
    want_q, want_s = quantize_linear(fc1)
    del dit, fc1
    t5 = t5m.T5Encoder(cfg.t5, dtype=torch.bfloat16, device=DEVICE)
    t5.init_weights(gen)
    torch.save(t5m.t5_state_dict(t5), ckpt / cfg.t5_checkpoint)
    del t5
    vae = vaem.init_params(cfg.vae, gen, device=DEVICE, encoder=True)
    torch.save(vae_convert.vae_state_dict(vae, cfg.vae),
               ckpt / cfg.vae_checkpoint)
    del vae
    torch.cuda.empty_cache()
    export_s = time.perf_counter() - t0
    ckpt_gib = sum(f.stat().st_size for f in ckpt.iterdir()) / 2**30
    log(f"phase 8b: exported a random {CKPT_TASK} checkpoint directory "
        f"({ckpt_gib:.2f} GiB) in {export_s:.1f} s")

    caches = [ckpt / f"moviigen_quant_{tag}_int8.safetensors"
              for tag in ("dit", "t5")]
    argv = ["--task", CKPT_TASK, "--device", DEVICE, "--size", "832*480",
            "--frame_num", "5", "--sample_steps", "2", "--base_seed", "42",
            "--prompt", PROMPT, "--ckpt_dir", str(ckpt), "--quant", "int8"]
    rows = []
    for start in ("first", "second"):
        if start == "second":  # quantizing again is a failure now
            def refuse(*args, **kwargs):
                raise RuntimeError("second start quantized again: the cache "
                                   "was not used")
            saved = t2v.quantize_wan_params, t2v.quantize_t5_params
            t2v.quantize_wan_params = t2v.quantize_t5_params = refuse
        mtimes = [c.stat().st_mtime_ns if c.exists() else None
                  for c in caches]
        fa.reset_launch_counts()
        ig.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            out = generate.main(argv + ["--save_file",
                                        str(root / f"{start}.mp4")])
        finally:
            if start == "second":
                t2v.quantize_wan_params, t2v.quantize_t5_params = saved
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        counts = {**fa.launch_counts(), **ig.launch_counts()}
        # weight-only int8 goes through cuBLAS: no int8 GEMM launch;
        # 2 steps x 1 batched forward x 2 attention sites x 2 blocks
        want = dict.fromkeys(counts, 0)
        want["launches"] = 2 * 2 * CKPT_DIT_LAYERS
        if counts != want:
            raise RuntimeError(f"ckpt_dir {start} start: launches {counts}, "
                               f"expected {want}")
        if out is None or not os.path.getsize(out):
            raise RuntimeError(f"ckpt_dir {start} start: no video written")
        if not all(c.exists() for c in caches):
            raise RuntimeError("ckpt_dir: quantized caches not written")
        if start == "second" and mtimes != [c.stat().st_mtime_ns
                                            for c in caches]:
            raise RuntimeError("ckpt_dir: second start rewrote the caches")
        rows.append(dict(start=start, total_s=total_s, launches=counts))
        log(f"phase 8b: generate --ckpt_dir --quant int8, {start} start: "
            + json.dumps(rows[-1]))
    # what is served is the checkpoint's weights, quantized
    pipe = t2v.WanT2V(cfg, device=DEVICE, checkpoint_dir=str(ckpt),
                      quant="int8")
    lin = pipe.dit.blocks[0].ffn_fc1
    if not (torch.equal(lin.qweight, want_q)
            and torch.equal(lin.scale, want_s)):
        raise RuntimeError("ckpt_dir: the cached int8 DiT is not the "
                           "quantized checkpoint")
    cache_gib = sum(c.stat().st_size for c in caches) / 2**30
    report["ckpt_dir"] = dict(task=CKPT_TASK, checkpoint_gib=ckpt_gib,
                              cache_gib=cache_gib, export_s=export_s,
                              starts=rows)
    log("phase 8b: " + json.dumps(report["ckpt_dir"]))
    del pipe
    shutil.rmtree(root)
    torch.cuda.empty_cache()


def phase_quant_profile(report):
    """One W8A8 DiT forward of the full t2v-14B (40 blocks) at the first
    request's shape under torch.profiler. Not in the default phases."""
    import torch

    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.models.wan_model import WanModel

    cfg = WAN_CONFIGS["t2v-14B"].model
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    model = WanModel(cfg, dtype=torch.bfloat16, device=DEVICE, quant="w8a8")
    model.init_weights(gen)
    with torch.no_grad():
        x, t, ctx, rope = _dit_inputs(cfg, gen)
        report["w8a8_profile"] = profile(
            lambda: model(x, t, ctx, rope, seq_len=7800),
            "t2v-14B W8A8, 40 blocks, 7,800 tokens, B=2", 9)
    del model
    torch.cuda.empty_cache()

# Phase 10: the preprocessing path at the CLI's defaults (1920×832 crops,
# 81 frames) with the full Wan VAE and umT5-XXL that t2v-14B and t2v-1.3B
# share, random weights from the CLI's seed.
PRE_TASK = "t2v-14B"
PRE_CLIPS = 3
PRE_FRAMES, PRE_H, PRE_W = 81, 832, 1920
# streaming against full-tensor encode: a slice the full encode fits at
PRE_CHECK_FRAMES, PRE_CHECK_H, PRE_CHECK_W = 17, 480, 832
# the clip fine-tuning reads: the finetune CLI's default 480×832 crops
PRE_FT_H, PRE_FT_W = 480, 832
# fp32 with TF32 off on both sides: the two orders of the same convs
# differ by fp32 rounding, orders of magnitude under 1e-3 of the latents'
# scale; a wrong cache (a frame lost or doubled) is off by O(1)
PRE_STREAM_REL_TOL = 1e-3
PRE_CAPTIONS = (PROMPT, "A red fox crosses a snowy field at dawn.",
                "Aerial shot of waves breaking on black volcanic rocks, "
                "slow motion, golden hour, the camera drifting left.")


def _write_clips(root, sizes, seed):
    """Synthetic raw clips as ``.npy`` ([T, H, W, 3] uint8, 16 fps) with
    their annotation json and merge file; returns the merge file."""
    rng = np.random.default_rng(seed)
    vids = root / "videos"
    vids.mkdir(parents=True)
    annos = []
    for i, (frames, h, w) in enumerate(sizes):
        path = vids / f"clip{i}.npy"
        np.save(path, rng.integers(0, 256, (frames, h, w, 3), np.uint8))
        annos.append({"path": str(path),
                      "cap": PRE_CAPTIONS[i % len(PRE_CAPTIONS)],
                      "fps": 16, "duration": frames / 16,
                      "resolution": {"height": h, "width": w}})
    (root / "annos.json").write_text(json.dumps(annos))
    merge = root / "merge.txt"
    merge.write_text(str(root / "annos.json") + "\n")
    return str(merge)


def _read_outputs(out_dir, items, latent_shape, text_dim, tokenizer):
    """Each item's latent and embedding, checked: fp32 latents of
    ``latent_shape`` and finite, embeddings [true_len, text_dim]."""
    out = {}
    for item in items:
        lat = np.load(out_dir / "latent" / item["latent_path"])
        emb = np.load(out_dir / "prompt_embed" / item["prompt_embed_path"])
        _, mask = tokenizer([item["caption"]], return_mask=True)
        want_emb = (int(mask[0].sum()), text_dim)
        if lat.shape != latent_shape or lat.dtype != np.float32 \
                or not np.isfinite(lat).all():
            raise RuntimeError(f"preprocess: latent {item['latent_path']} "
                               f"{lat.shape} {lat.dtype}")
        if emb.shape != want_emb or not np.isfinite(emb).all():
            raise RuntimeError(f"preprocess: embedding {emb.shape}, "
                               f"expected {want_emb}")
        out[item["latent_path"]] = (lat, emb)
    return out


def phase_preprocess(report):
    """(a) ``cli.preprocess`` at its defaults on 3 synthetic 1920×832×81
    clips, then resumed; (b) ``encode_streaming`` against ``encode`` in
    fp32; (c) ``cli.preprocess_stages`` vae + text on the same clips;
    (d) one 832×480 clip preprocessed and ``cli.finetune`` taking a
    t2v-1.3B step on it; (e) the 14B pipeline's decodes of a 1920×832×81
    latent beside the DiT and a 1920×1072×81 one with the DiT parked, then
    an r1 request with the DiT back."""
    import importlib.util
    import pathlib
    import shutil

    import torch

    from moviigen_tpu_torch.cli import finetune, preprocess, preprocess_stages
    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.models import vae as vaem
    from moviigen_tpu_torch.models.tokenizer import load_tokenizer
    from moviigen_tpu_torch.models.vae_streaming import encode_streaming

    found = {m: importlib.util.find_spec(m) is not None
             for m in ("cv2", "imageio", "decord", "torchcodec")}
    log(f"phase 10: video modules installed {found}")
    cfg = WAN_CONFIGS[PRE_TASK]
    tokenizer = load_tokenizer(cfg.t5_tokenizer, seq_len=cfg.model.text_len,
                               vocab_size=cfg.t5.vocab_size)
    root = pathlib.Path(__file__).resolve().parent / "_smoke_out" / "pre"
    shutil.rmtree(root, ignore_errors=True)
    merge = _write_clips(root, [(PRE_FRAMES, PRE_H, PRE_W)] * PRE_CLIPS, 0)
    out = root / "out"
    latent_shape = (cfg.vae.z_dim, (PRE_FRAMES - 1) // 4 + 1, PRE_H // 8,
                    PRE_W // 8)
    row = dict(task=PRE_TASK, clips=PRE_CLIPS, frames=PRE_FRAMES,
               size=f"{PRE_W}*{PRE_H}", modules=found)

    # (a) the one-pass CLI at its defaults, then resumed
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out_json = preprocess.main(["--data_merge_path", merge,
                                "--output_dir", str(out),
                                "--task", PRE_TASK])
    torch.cuda.synchronize()
    row["run_s"] = time.perf_counter() - t0
    row["run_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    stats = json.loads((out / "preprocess_stats_shard0.json").read_text())
    items = json.loads(pathlib.Path(out_json).read_text())
    if stats["errors"] or stats["processed"] != PRE_CLIPS \
            or len(items) != PRE_CLIPS or len(stats["vae_s"]) != PRE_CLIPS:
        raise RuntimeError(f"preprocess: stats {stats}, {len(items)} items")
    one_pass = _read_outputs(out, items, latent_shape, cfg.t5.dim, tokenizer)
    row.update({k: stats[k] for k in ("encode_dtype", "vae_s", "t5_s",
                                      "vae_peak_gib")})
    t0 = time.perf_counter()
    preprocess.main(["--data_merge_path", merge, "--output_dir", str(out),
                     "--task", PRE_TASK])
    row["resume_s"] = time.perf_counter() - t0
    stats = json.loads((out / "preprocess_stats_shard0.json").read_text())
    latest = json.loads((out / "videos2caption_latest.json").read_text())
    if stats["errors"] or stats["vae_s"] or len(latest) != PRE_CLIPS:
        raise RuntimeError(f"preprocess resume: stats {stats}, "
                           f"{len(latest)} items")
    log("phase 10a: " + json.dumps(row))
    torch.cuda.empty_cache()

    # (b) streaming against full-tensor encode, fp32
    gen = torch.Generator(device=DEVICE).manual_seed(42)
    vae = vaem.init_params(cfg.vae, gen, device=DEVICE, encoder=True)
    video = torch.rand((1, 3, PRE_CHECK_FRAMES, PRE_CHECK_H, PRE_CHECK_W),
                       generator=gen, device=DEVICE) * 2 - 1
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full = vaem.encode(vae, video, cfg.vae)
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        stream = encode_streaming(vae, video, cfg.vae)
        torch.cuda.synchronize()
        stream_s = time.perf_counter() - t0
    _, err = rel_err(stream, full)
    check = dict(frames=PRE_CHECK_FRAMES,
                 size=f"{PRE_CHECK_W}*{PRE_CHECK_H}", dtype="float32",
                 rel_err=err, tol=PRE_STREAM_REL_TOL, full_s=full_s,
                 stream_s=stream_s, shape=list(full.shape))
    log("phase 10b: " + json.dumps(check))
    if not err <= PRE_STREAM_REL_TOL:
        raise RuntimeError(f"streaming encode: rel err {err}")
    row["streaming_check"] = check
    del vae, video, full, stream
    torch.cuda.empty_cache()

    # (c) the split stages on the same clips: the same files
    stages = root / "stages"
    t0 = time.perf_counter()
    temp_json = preprocess_stages.main(["vae", "--data_merge_path", merge,
                                        "--output_dir", str(stages),
                                        "--task", PRE_TASK])
    final_json = preprocess_stages.main(["text", "--json_path", temp_json,
                                         "--output_dir", str(stages),
                                         "--task", PRE_TASK])
    row["stages_s"] = time.perf_counter() - t0
    split = _read_outputs(stages, json.loads(
        pathlib.Path(final_json).read_text()), latent_shape, cfg.t5.dim,
        tokenizer)
    if split.keys() != one_pass.keys():
        raise RuntimeError(f"stages wrote {sorted(split)}, the one-pass "
                           f"CLI {sorted(one_pass)}")
    for name, (lat, emb) in split.items():
        if not (np.array_equal(lat, one_pass[name][0])
                and np.array_equal(emb, one_pass[name][1])):
            raise RuntimeError(f"stages: {name} differs from the one-pass "
                               f"CLI's (latent max diff "
                               f"{np.abs(lat - one_pass[name][0]).max()})")
    log(f"phase 10c: split stages equal to the one-pass CLI in "
        f"{row['stages_s']:.1f} s")
    shutil.rmtree(root)

    # (d) fine-tuning reads the port's own caches
    merge = _write_clips(root, [(PRE_FRAMES, PRE_FT_H, PRE_FT_W)], 1)
    t0 = time.perf_counter()
    out_json = preprocess.main(["--data_merge_path", merge, "--output_dir",
                                str(out), "--task", PRE_TASK,
                                "--crop_height", str(PRE_FT_H),
                                "--crop_width", str(PRE_FT_W)])
    row["finetune_preprocess_s"] = time.perf_counter() - t0
    items = json.loads(pathlib.Path(out_json).read_text())
    _read_outputs(out, items, (cfg.vae.z_dim, latent_shape[1],
                               PRE_FT_H // 8, PRE_FT_W // 8),
                  cfg.t5.dim, tokenizer)
    torch.cuda.empty_cache()
    record = finetune.main([
        "--task", TRAIN_TASK, "--device", DEVICE,
        "--data_json_path", str(out / "videos2caption_latest.json"),
        "--num_latent_t", str(latent_shape[1]), "--gradient_checkpointing",
        "--max_train_steps", "1", "--checkpointing_steps", "1000",
        "--output_dir", str(root / "train"), "--seed", "0"])
    loss = record["loss"]
    if record["step"] != 1 or not np.isfinite(loss).all():
        raise RuntimeError(f"finetune on the port's caches: step "
                           f"{record['step']}, loss {loss}")
    row.update(finetune_loss=loss, finetune_step_s=record["step_s"])
    log(f"phase 10d: t2v-1.3B step on the port's caches, loss {loss}")
    del record
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    report["preprocess"] = row
    phase_big_decode(report)


def phase_big_decode(report):
    """(e) With the t2v-14B DiT, the umT5-XXL and the VAE resident, the
    pipeline's decode stage of two 81-frame requests: 1920×832, whose
    decode fits beside the DiT (``decode_gib`` under FREE_DIT_DECODE_GIB),
    and 1920×1072, which parks the DiT in host memory first; then an r1
    request brings the DiT back, its launches counted as in phase 4."""
    import torch

    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.ops import flash_attention as fa
    from moviigen_tpu_torch.pipelines.text2video import (
        FREE_DIT_DECODE_GIB, WanT2V, compute_target_shape_and_seq_len,
        decode_gib)

    config = WAN_CONFIGS[PRE_TASK]
    pipe = WanT2V(config, device=DEVICE)
    rows = []
    for w, h in ((PRE_W, PRE_H), (1920, 1072)):
        target_shape, _, _ = compute_target_shape_and_seq_len(
            config, (w, h), PRE_FRAMES)
        latent = torch.randn((1, *target_shape), device=DEVICE,
                             generator=torch.Generator(device=DEVICE)
                             .manual_seed(3))
        estimate = decode_gib(latent.shape, config.vae)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        pipe.timings = {}
        t0 = time.perf_counter()
        video = pipe.decode_request(latent)
        total_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        after = torch.cuda.memory_allocated() / 2**30
        row = dict(size=f"{w}*{h}", frames=PRE_FRAMES,
                   decode_gib_estimate=estimate,
                   threshold_gib=FREE_DIT_DECODE_GIB, parked=pipe.dit_parked,
                   resident_gib=resident, peak_gib=peak,
                   decode_own_gib=peak - after,
                   dit_park_s=pipe.timings.get("dit_park_s"),
                   decode_s=pipe.timings["decode_s"], total_s=total_s)
        if pipe.dit_parked != (estimate > FREE_DIT_DECODE_GIB):
            raise RuntimeError(f"big decode {w}*{h}: parked "
                               f"{pipe.dit_parked} at {estimate:.2f} GiB")
        if video.shape != (3, PRE_FRAMES, h, w) \
                or not np.isfinite(video).all() or np.abs(video).max() > 1.0:
            raise RuntimeError(f"big decode {w}*{h}: video {video.shape}")
        del video, latent
        log("phase 10e: " + json.dumps(row))
        rows.append(row)
    if not pipe.dit_parked:
        raise RuntimeError("big decode: no decode parked the DiT")

    name, frames, steps, solver = REQUESTS[0]
    fa.reset_launch_counts()
    video = pipe.generate(PROMPT, size=(832, 480), frame_num=frames,
                          sampling_steps=steps, sample_solver=solver, seed=42)
    launches = fa.launch_counts()["launches"]
    expected = steps * 2 * config.model.num_layers  # batched CFG at r1
    _serve_checks(name, video, frames)
    if pipe.dit_parked or "dit_unpark_s" not in pipe.timings:
        raise RuntimeError("the request after the big decode did not bring "
                           "the DiT back")
    if launches != expected:
        raise RuntimeError(f"{name} after the big decode: flash kernel "
                           f"launched {launches} times, expected {expected}")
    after = dict(request=name, launches=launches,
                 dit_unpark_s=pipe.timings["dit_unpark_s"],
                 step_s=pipe.timings["step_s"],
                 decode_s=pipe.timings["decode_s"])
    log("phase 10e: next request " + json.dumps(after))
    report["big_decode"] = dict(decodes=rows, after=after)
    del pipe
    torch.cuda.empty_cache()


# ------------------------------------------------------------- LoRA / QLoRA

# The 14B's attention at the fine-tune CLI's default shape (N = 40 heads,
# 32,760 tokens, B=1) and its 512-key cross-attention, through phase 2's
# wrappers: the kernels QLoRA runs, at the width no earlier phase timed.
TRAIN14_HEADS = 40
TRAIN14_CASES = [
    ("m_stats_self_N40_L32760", "stats", 1, 32760, 32760, None),
    ("m2_stats_cross_N40_Lq32760_Lk512", "stats", 1, 32760, 512, None),
    ("n_bwd_self_N40_L32760", "bwd", 1, 32760, 32760, None),
    ("o_bwd_cross_N40_Lq32760_Lk512", "bwd", 1, 32760, 512, None),
]
LORA_TASK = "t2v-14B"
LORA_STEPS = 3
LORA_RANK, LORA_ALPHA = 64, 64
# Large enough that every adapter moves measurably in 3 steps: AdamW moves
# each element by about the learning rate a step (B from step 1, A from
# step 2, once B is non-zero), against A's N(0, 1)/64 init. At 1e-3 the
# random model's loss grew 4 -> 21 in 3 steps.
LORA_LR = 2e-4
LORA_GRAD_LAYERS = 2
# Adapter gradients, kernels against the plain attention (norm-relative):
# the backward kernels' bf16 rounding of P and dS (GRAD_REL_TOL), carried
# through the side paths' bf16 products.
LORA_GRAD_REL_TOL = GRAD_REL_TOL
OT_TASK, OT_LATENT, OT_STEPS = "t2v-1.3B", (16, 5, 60, 104), 2
WATCH_FRAMES, WATCH_STEPS = 17, 2


@contextlib.contextmanager
def live_head():
    """Inside, ``WanModel.init_weights`` also draws the head (std 0.02)
    from its generator. A random model's zero head gives every block, and
    so every adapter, a zero gradient, and a zero prediction with or
    without adapters; a checkpoint's head is live."""
    import torch

    from moviigen_tpu_torch.models.wan_model import WanModel

    init = WanModel.init_weights

    def init_live(self, generator):
        init(self, generator)
        with torch.no_grad():
            self.head.weight.normal_(0.0, 0.02, generator=generator)
        return self

    WanModel.init_weights = init_live
    try:
        yield
    finally:
        WanModel.init_weights = init


def _latent_dataset(root, latent, clips, text_dim, seed):
    """A synthetic latent set in the reference layout under ``root``."""
    for d in (root / "latent", root / "prompt_embed"):
        d.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    annos = []
    for i in range(clips):
        np.save(root / "latent" / f"clip{i}.npy",
                rng.standard_normal(latent, dtype=np.float32))
        np.save(root / "prompt_embed" / f"clip{i}.npy",
                rng.standard_normal((PROMPT_LENS[i % len(PROMPT_LENS)],
                                     text_dim), dtype=np.float32))
        annos.append({"latent_path": f"clip{i}.npy",
                      "prompt_embed_path": f"clip{i}.npy",
                      "length": 81, "aspect_ratio_bin": 0})
    path = root / "videos2caption.json"
    path.write_text(json.dumps(annos))
    return path


def phase_qlora(report):
    """(a) ``cli.finetune --task t2v-14B --use_lora --quant int8
    --gradient_checkpointing --export_safetensors`` as a user runs it: the
    full-width, full-depth 14B, its block linears int8 weight-only (random
    codes made on the card), rank-64 adapters, 3 steps at 32,760 tokens;
    launches counted, every adapter moved, the base bit-equal to a fresh
    build from the seed, the checkpoint and the peft export read back."""
    import pathlib
    import shutil

    import torch

    from moviigen_tpu_torch.cli import finetune
    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.models.wan_model import WanModel
    from moviigen_tpu_torch.ops import flash_attention as fa
    from moviigen_tpu_torch.ops import int8_gemm as ig
    from moviigen_tpu_torch.training import checkpoint as ck
    from moviigen_tpu_torch.training.lora import (init_lora_params,
                                                  lora_state_dict)
    from moviigen_tpu_torch.utils.safetensors import load_file

    root = pathlib.Path(__file__).resolve().parent / "_smoke_out" / "lora"
    shutil.rmtree(root, ignore_errors=True)
    cfg = WAN_CONFIGS[LORA_TASK].model
    data_json = _latent_dataset(root / "data", TRAIN_LATENT, 2,
                                cfg.text_dim, 0)
    out_dir = root / "out"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    ig.reset_launch_counts()
    t0 = time.perf_counter()
    with live_head():
        record = finetune.main([
            "--task", LORA_TASK, "--device", DEVICE, "--use_lora",
            "--quant", "int8", "--gradient_checkpointing",
            "--export_safetensors", "--lora_rank", str(LORA_RANK),
            "--lora_alpha", str(LORA_ALPHA),
            "--learning_rate", str(LORA_LR),
            "--data_json_path", str(data_json), "--num_latent_t", "21",
            "--max_train_steps", str(LORA_STEPS),
            "--checkpointing_steps", "1000", "--output_dir", str(out_dir),
            "--seed", "0"])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    counts = {**fa.launch_counts(), **ig.launch_counts()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    report["qlora_launches"] = counts
    sites = 2 * cfg.num_layers
    want = dict.fromkeys(counts, 0)
    want.update(stats_launches=2 * sites * LORA_STEPS,
                dkv_launches=sites * LORA_STEPS,
                dq_launches=sites * LORA_STEPS)
    losses, gnorms = record["loss"], record["grad_norm"]
    log(f"phase 11a: QLoRA {LORA_TASK} int8, {LORA_STEPS} steps in "
        f"{main_s:.1f} s: loss {losses}, grad_norm {gnorms}, step_s "
        f"{record['step_s']}, peak {peak_gib:.2f} GiB, launches {counts}")
    if record["step"] != LORA_STEPS or len(losses) != LORA_STEPS:
        raise RuntimeError(f"qlora: stopped at step {record['step']}")
    if not (np.isfinite(losses).all() and np.isfinite(gnorms).all()
            and min(gnorms) > 0):
        raise RuntimeError(f"qlora: loss {losses}, grad_norm {gnorms}")
    if counts != want:
        raise RuntimeError(f"qlora: launches {counts}, expected {want}")

    model, adapters, opt = (record["model"], record["adapters"],
                            record["optimizer"])
    n_lora = sum(ad.A.numel() + ad.B.numel() for ad in adapters.values())
    start = init_lora_params(model, rank=LORA_RANK,
                             generator=torch.Generator(device=DEVICE)
                             .manual_seed(1))
    moved = {}
    for path, ad in adapters.items():
        for name in ("A", "B"):
            a = getattr(ad, name).detach()
            b = getattr(start[path], name).detach()
            if torch.equal(a, b):
                raise RuntimeError(f"qlora: {path}.{name} did not move")
            moved[f"{path}.{name}"] = float((a - b).norm()
                                            / b.norm().clamp_min(1e-30)) \
                if name == "A" else float(a.norm())
    del start
    with live_head():
        fresh = WanModel(cfg, dtype=torch.float32, device=DEVICE,
                         quant="int8").init_weights(
            torch.Generator(device=DEVICE).manual_seed(0))
    trained = {k: v for k, v in model.state_dict().items()
               if ".lora." not in k}
    base = fresh.state_dict()
    if set(trained) != set(base) or not all(
            torch.equal(trained[k], v) for k, v in base.items()):
        raise RuntimeError("qlora: the frozen base changed")
    del fresh, base, trained

    path = pathlib.Path(record["checkpoint"])
    files = {f.name: f.stat().st_size for f in path.iterdir()}
    saved = load_file(str(path / ck.PARAMS_FILE))
    named = lora_state_dict(adapters)
    if set(saved) != set(named) or not all(
            torch.equal(saved[k], v.detach().cpu()) for k, v in
            named.items()):
        raise RuntimeError("qlora: the adapters read back differ")
    state = torch.load(path / ck.OPT_FILE, map_location="cpu",
                       weights_only=True)
    mine = opt.state_dict()
    if state["count"] != LORA_STEPS or not all(
            torch.equal(a, b.cpu()) for key in ("m", "v")
            for a, b in zip(state[key], mine[key])):
        raise RuntimeError("qlora: the AdamW state read back differs")
    meta = ck.read_meta(str(path))
    if {k: meta.get(k) for k in ("lora", "quant", "lora_rank", "lora_alpha",
                                 "lora_dtype")} != dict(
            lora=True, quant="int8", lora_rank=LORA_RANK,
            lora_alpha=LORA_ALPHA, lora_dtype="float32"):
        raise RuntimeError(f"qlora: meta.json {meta}")
    peft = ck.lora_from_peft_state_dict(
        load_file(str(path / ck.LORA_EXPORT_NAME)), device=DEVICE)
    if set(peft) != set(adapters) or not all(
            torch.equal(peft[p].A, ad.A) and torch.equal(peft[p].B, ad.B)
            for p, ad in adapters.items()):
        raise RuntimeError("qlora: the peft export reads back differently")
    row = dict(task=LORA_TASK, quant="int8", layers=cfg.num_layers,
               tokens=32760, rank=LORA_RANK, alpha=LORA_ALPHA, lr=LORA_LR,
               adapter_params=n_lora, steps=LORA_STEPS,
               step_s=record["step_s"],
               step_s_median_2_3=statistics.median(record["step_s"][1:]),
               loss=losses, grad_norm=gnorms, peak_gib=peak_gib,
               checkpoint_gib=sum(files.values()) / 2**30,
               checkpoint_files=files,
               checkpoint_save_s=record["checkpoint_s"],
               adapter_moved_min=min(moved.values()),
               launches=counts, expected_launches=want)
    log("phase 11a: qlora " + json.dumps(row))
    report["qlora"] = row
    report["qlora_out"] = str(out_dir)
    del record, model, adapters, opt, saved, peft
    torch.cuda.empty_cache()


def _live_adapters(model, gen):
    """Rank-64 adapters on ``model`` with B drawn too (std 0.01), so that
    the side paths change the prediction and every dA is non-zero."""
    import torch

    from moviigen_tpu_torch.training.lora import attach_lora, init_lora_params

    adapters = init_lora_params(model, rank=LORA_RANK, generator=gen)
    with torch.no_grad():
        for ad in adapters.values():
            ad.B.normal_(0.0, 0.01, generator=gen)
    attach_lora(model, adapters, alpha=LORA_ALPHA, rank=LORA_RANK)
    return adapters


def phase_lora_grads(report):
    """(b) Adapter gradients of a 2-block t2v-14B at full width over an
    int8 base, 32,760 tokens, per-block remat: through the kernels against
    the plain attention, per adapter tensor."""
    import torch

    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.models.wan_model import WanModel
    from moviigen_tpu_torch.ops import flash_attention as fa
    from moviigen_tpu_torch.ops.rope import rope_3d_freqs
    from moviigen_tpu_torch.training.lora import (lora_parameters,
                                                  lora_state_dict)

    cfg = WAN_CONFIGS[LORA_TASK].model.replace(num_layers=LORA_GRAD_LAYERS)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    with live_head():
        model = WanModel(cfg, dtype=torch.float32, device=DEVICE,
                         quant="int8").init_weights(gen)
    model.requires_grad_(False)
    adapters = _live_adapters(model, gen)
    names, params = list(lora_state_dict(adapters)), list(
        lora_parameters(adapters))
    _, f, h, w = TRAIN_LATENT
    rope = rope_3d_freqs((f, h // 2, w // 2), cfg.head_dim, device=DEVICE)
    x = torch.randn(1, *TRAIN_LATENT, generator=gen, device=DEVICE)
    t = torch.full((1,), 500.0, device=DEVICE)
    ctx = torch.randn(1, cfg.text_len, cfg.text_dim, generator=gen,
                      device=DEVICE)
    ctx[:, PROMPT_LENS[2]:] = 0.0
    target = torch.randn(x.shape, generator=gen, device=DEVICE)
    sites = 2 * LORA_GRAD_LAYERS
    want_counts = {
        "auto": dict(dict.fromkeys(fa.COUNTERS, 0), stats_launches=2 * sites,
                     dkv_launches=sites, dq_launches=sites),
        "plain": dict.fromkeys(fa.COUNTERS, 0)}
    grads = {}
    for backend in ("auto", "plain"):
        fa.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = model(x, t, ctx, rope, attn_backend=backend, remat=True)
        loss = torch.mean(torch.square(pred - target))
        grads[backend] = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        counts = fa.launch_counts()
        log(f"phase 11b: {LORA_GRAD_LAYERS}-block t2v-14B int8 + adapters, "
            f"32,760 tokens, attn={backend}: loss {loss.item():.6f}, "
            f"forward+backward {time.perf_counter() - t0:.3f} s, launches "
            f"{counts}")
        if counts != want_counts[backend]:
            raise RuntimeError(f"lora grads attn={backend}: launches "
                               f"{counts}, expected {want_counts[backend]}")
        del pred, loss
    errs, zero = {}, []
    for name, g, w in zip(names, grads["auto"], grads["plain"]):
        if not bool(w.abs().max() > 0):
            zero.append(name)
        errs[name] = float((g - w).norm() / w.norm().clamp_min(1e-30))
    worst = sorted(errs.items(), key=lambda kv: -kv[1])
    row = dict(layers=LORA_GRAD_LAYERS, tokens=32760, quant="int8",
               tensors=len(errs), max_rel_err=worst[0][1],
               worst=dict(worst[:4]),
               median_rel_err=statistics.median(errs.values()))
    log("phase 11b: lora grads " + json.dumps(row))
    if zero:
        raise RuntimeError(f"lora grads: all-zero gradients {zero[:4]}")
    bad = {n: e for n, e in errs.items() if not e <= LORA_GRAD_REL_TOL}
    if bad:
        raise RuntimeError(f"lora grads: kernel vs plain past "
                           f"{LORA_GRAD_REL_TOL} (norm-relative): {bad}")
    report["lora_grads"] = row
    del model, adapters, grads, params
    torch.cuda.empty_cache()


def phase_lora_w8a8(report):
    """(c) Phase 3's depth-cut t2v-14B W8A8 DiT with live adapters: the
    kernel path (int8 GEMM, activation quantization, flash forward) and
    the side paths against the plain path; detaching gives the base's
    output back bit for bit."""
    import torch

    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.models.wan_model import WanModel
    from moviigen_tpu_torch.ops import flash_attention as fa
    from moviigen_tpu_torch.ops import int8_gemm as ig
    from moviigen_tpu_torch.training.lora import detach_lora

    cfg = WAN_CONFIGS["t2v-14B"].model.replace(num_layers=DIT_SMOKE_LAYERS)
    gen = torch.Generator(device=DEVICE).manual_seed(10)
    with live_head():
        model = WanModel(cfg, dtype=torch.bfloat16, device=DEVICE,
                         quant="w8a8").init_weights(gen)
    with torch.no_grad():
        x, t, ctx, rope = _dit_inputs(cfg, gen)
        bare = model(x, t, ctx, rope, seq_len=7800).float()
        _live_adapters(model, gen)
        fa.reset_launch_counts()
        ig.reset_launch_counts()
        got = model(x, t, ctx, rope, seq_len=7800).float()
        counts = {**fa.launch_counts(), **ig.launch_counts()}
        with plain_int8_gemm():
            want = model(x, t, ctx, rope, seq_len=7800,
                         attn_backend="plain").float()
        taken = detach_lora(model)
        again = model(x, t, ctx, rope, seq_len=7800).float()
    torch.cuda.synchronize()
    expected = dict.fromkeys(counts, 0)
    expected.update(launches=2 * DIT_SMOKE_LAYERS,
                    int8_gemm_launches=10 * DIT_SMOKE_LAYERS,
                    quantize_launches=7 * DIT_SMOKE_LAYERS)
    rel = float((got - want).norm() / want.norm())
    row = dict(layers=DIT_SMOKE_LAYERS, tokens=7800, adapters=len(taken),
               rel_norm_err=rel,
               adapter_effect=float((got - bare).norm() / bare.norm()),
               detached_equal=bool(torch.equal(again, bare)),
               launches=counts)
    log("phase 11c: w8a8 + adapters " + json.dumps(row))
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError("w8a8 + adapters: non-finite prediction")
    if counts != expected:
        raise RuntimeError(f"w8a8 + adapters: launches {counts}, expected "
                           f"{expected}")
    if rel > DIT_REL_TOL:
        raise RuntimeError(f"w8a8 + adapters: kernel vs plain {rel:.3e} > "
                           f"{DIT_REL_TOL}")
    if not row["detached_equal"] or row["adapter_effect"] == 0.0:
        raise RuntimeError("w8a8 + adapters: detaching did not give the "
                           "base back, or the adapters changed nothing")
    report["lora_w8a8"] = row
    report["lora_w8a8_launches"] = counts
    del model, taken, got, want, bare, again
    torch.cuda.empty_cache()


def _host_brute_force(latents, noise):
    """The OT permutation by brute force in float64 on the host."""
    import itertools

    x = latents.reshape(latents.shape[0], -1).double()
    y = noise.reshape(noise.shape[0], -1).double()
    cost = -(x / x.norm(dim=1, keepdim=True)) @ (
        y / y.norm(dim=1, keepdim=True)).t()
    n = cost.shape[0]
    perms = np.array(list(itertools.permutations(range(n))))
    totals = cost.numpy()[np.arange(n), perms].sum(axis=1)
    return perms[int(np.argmin(totals))].tolist()


def phase_ot(report):
    """(d) ``cli.finetune --task t2v-1.3B --use_lora --compute_ot
    --train_batch_size 2``, 2 steps over an fp32 base: the permutation the
    card chose for each batch equals the host's float64 brute force. The
    CLI's draws may well pair each latent with its own row; so, at the
    same latent size, ``ot_pair_noise`` on the card also gets batches of
    2 and 8 whose latents are shuffled noise rows plus a little noise,
    where the optimum is the shuffle."""
    import pathlib
    import shutil

    import torch

    from moviigen_tpu_torch.cli import finetune
    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.ops import flash_attention as fa
    from moviigen_tpu_torch.training import train_step as ts

    root = pathlib.Path(__file__).resolve().parent / "_smoke_out" / "ot"
    shutil.rmtree(root, ignore_errors=True)
    cfg = WAN_CONFIGS[OT_TASK].model
    data_json = _latent_dataset(root / "data", OT_LATENT, 4, cfg.text_dim, 1)
    calls = []
    pair = ts.ot_pair_noise

    def recorded(latents, noise):
        out = pair(latents, noise)
        calls.append(tuple(a.detach().cpu() for a in (latents, noise, out)))
        return out

    fa.reset_launch_counts()
    ts.ot_pair_noise = recorded
    t0 = time.perf_counter()
    try:
        with live_head():
            record = finetune.main([
                "--task", OT_TASK, "--device", DEVICE, "--use_lora",
                "--compute_ot", "--train_batch_size", "2",
                "--gradient_checkpointing", "--learning_rate", str(LORA_LR),
                "--data_json_path", str(data_json), "--num_latent_t",
                str(OT_LATENT[1]), "--max_train_steps", str(OT_STEPS),
                "--checkpointing_steps", "1000",
                "--output_dir", str(root / "out"), "--seed", "0"])
    finally:
        ts.ot_pair_noise = pair
    main_s = time.perf_counter() - t0
    report["ot_launches"] = fa.launch_counts()
    shuffles = []
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    for b in (2, 8):
        noise = torch.randn(b, *OT_LATENT, generator=gen, device=DEVICE)
        shuffle = torch.randperm(b, generator=gen, device=DEVICE)
        if b == 2:
            shuffle = torch.tensor([1, 0], device=DEVICE)
        latents = noise[shuffle] + 0.1 * torch.randn(
            noise.shape, generator=gen, device=DEVICE)
        calls.append(tuple(a.cpu() for a in (
            latents, noise, pair(latents, noise))))
        shuffles.append(shuffle.tolist())
    perms = []
    for latents, noise, out in calls:
        chosen = [next(j for j in range(noise.shape[0])
                       if torch.equal(out[i], noise[j]))
                  for i in range(out.shape[0])]
        perms.append((chosen, _host_brute_force(latents, noise)))
    row = dict(task=OT_TASK, batch=2, tokens=7800, steps=OT_STEPS,
               seconds=main_s, loss=record["loss"],
               grad_norm=record["grad_norm"], permutations=perms,
               shuffles=shuffles, launches=report["ot_launches"])
    log("phase 11d: ot " + json.dumps(row))
    if (len(calls) != OT_STEPS + 2 or any(a != b for a, b in perms)
            or [p[0] for p in perms[-2:]] != shuffles):
        raise RuntimeError(f"ot: the card's permutations {perms} (card, "
                           f"host) in {len(calls)} calls")
    if not np.isfinite(record["loss"]).all():
        raise RuntimeError(f"ot: loss {record['loss']}")
    report["ot"] = row
    del record
    shutil.rmtree(root)
    torch.cuda.empty_cache()


def phase_watcher(report):
    """(e) ``cli.valid_training --once --task t2v-14B`` over (a)'s output
    directory with a random bf16 base: the adapter-only checkpoint
    restored and attached, one 832×480×17 prompt rendered in 2 steps with
    the forward kernel's launches counted; one DiT forward with the
    adapters differs from the same forward without them."""
    import pathlib
    import shutil

    import torch

    from moviigen_tpu_torch.cli import valid_training
    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.ops import flash_attention as fa

    out_dir = report.get("qlora_out")
    if out_dir is None:
        raise RuntimeError("watcher: phase 11a wrote no checkpoint")
    root = pathlib.Path(out_dir).parent
    prompts = root / "prompts"
    prompts.mkdir(exist_ok=True)
    (prompts / "cats.txt").write_text(PROMPT)
    config = WAN_CONFIGS[LORA_TASK]
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    with live_head():
        record = valid_training.main([
            "--task", LORA_TASK, "--device", DEVICE, "--once",
            "--output_dir", out_dir, "--prompt_dir", str(prompts),
            "--size", "832*480", "--frame_num", str(WATCH_FRAMES),
            "--sample_steps", str(WATCH_STEPS)])
    total_s = time.perf_counter() - t0
    counts = fa.launch_counts()
    report["watcher_launches"] = counts["launches"]
    (render,) = record["renders"]
    video = render["videos"]["cats"]
    _serve_checks("watcher", video, WATCH_FRAMES)
    expected = dict.fromkeys(counts, 0)
    expected["launches"] = WATCH_STEPS * 2 * config.model.num_layers
    pipe = record["pipe"]
    mounted = sum(1 for n, _ in pipe.dit.named_parameters() if ".lora." in n)
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    with torch.no_grad():
        x, t, ctx, rope = _dit_inputs(config.model, gen)
        with_lora = pipe.dit(x, t, ctx, rope, seq_len=7800).float()
        taken = pipe.detach_lora()
        without = pipe.dit(x, t, ctx, rope, seq_len=7800).float()
        pipe.attach_lora(taken, alpha=LORA_ALPHA, rank=LORA_RANK)
    effect = float((with_lora - without).norm() / without.norm())
    row = dict(task=LORA_TASK, size="832*480", frames=WATCH_FRAMES,
               steps=WATCH_STEPS, lora=render["lora"], step=render["step"],
               adapters_mounted=mounted // 2, seconds=total_s,
               step_s=pipe.timings["step_s"],
               decode_s=pipe.timings["decode_s"],
               video_std=float(video.std()), adapter_effect=effect,
               launches=counts, saved=render["saved"])
    log("phase 11e: watcher " + json.dumps(row))
    if not render["lora"] or mounted != 2 * 8 * config.model.num_layers:
        raise RuntimeError(f"watcher: {mounted} adapter tensors mounted")
    if counts != expected:
        raise RuntimeError(f"watcher: launches {counts}, expected "
                           f"{expected}")
    if not effect > 0.0:
        raise RuntimeError("watcher: the adapters do not change the DiT")
    report["watcher"] = row
    del record, pipe, taken, with_lora, without
    shutil.rmtree(root)
    torch.cuda.empty_cache()


def phase_lora(report):
    train_kernel_cases(report, TRAIN14_CASES, TRAIN14_HEADS,
                       key="train14_cases", phase="11k")
    phase_qlora(report)
    phase_lora_grads(report)
    phase_lora_w8a8(report)
    phase_ot(report)
    phase_watcher(report)


# ------------------------------------------------------------------- i2v

# Phase 12: image-to-video at i2v-14B (the t2v-14B DiT with in_dim 36 and
# the image cross-attention), the fp32 ViT-H/14 CLIP tower, random weights.
I2V_TASK = "i2v-14B"
I2V_FRAMES, I2V_STEPS = 17, 4  # 832*480: 7,800 tokens, batched CFG
# CLIP features, fp32 kernel path against plain attention (TF32 off): the
# two attentions differ by fp32 rounding (F32_REL_TOL) and 31 blocks of
# fp32 GEMMs carry it on without amplifying it much; 1e-4 of the
# features' scale bounds that, a broken attention is off by O(1).
CLIP_REL_TOL = 1e-4


def _i2v_dit_inputs(cfg, gen):
    """The i2v request's DiT inputs at 832*480*17: B=2 (batched CFG),
    latents [2, 16, 5, 60, 104], y [2, 20, ...], clip_fea [2, 257, 1280]."""
    import torch

    from moviigen_tpu_torch.ops.rope import rope_3d_freqs

    z = 16
    x = torch.randn(2, z, 5, 60, 104, generator=gen, device=DEVICE)
    y = torch.randn(2, cfg.in_dim - z, 5, 60, 104, generator=gen,
                    device=DEVICE)
    clip_fea = torch.randn(2, 257, 1280, generator=gen, device=DEVICE)
    t = torch.full((2,), 500.0, device=DEVICE)
    ctx = torch.randn(2, cfg.text_len, cfg.text_dim, generator=gen,
                      device=DEVICE)
    rope = rope_3d_freqs((5, 30, 52), cfg.head_dim, device=DEVICE)
    return (x, t, ctx, rope), dict(clip_fea=clip_fea, y=y)


def phase_i2v_clip(report):
    """(a) The full ViT-H/14 (31 blocks, fp32) on one 832×480 image: the
    fp32 kernel path against plain attention, 31 kernel launches."""
    import torch

    from moviigen_tpu_torch.models import clip as clipm
    from moviigen_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=DEVICE).manual_seed(2)
    model = clipm.CLIPVision(device=DEVICE).init_weights(gen).eval()
    image = torch.rand(1, 3, 480, 832, generator=gen, device=DEVICE) * 2 - 1
    feats, secs = {}, {}
    for backend in ("auto", "plain", "auto"):
        fa.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats[backend] = clipm.visual_features(model, image, backend=backend)
        torch.cuda.synchronize()
        secs[backend] = time.perf_counter() - t0  # the second auto: warm
        counts = fa.launch_counts()
        want = dict.fromkeys(counts, 0)
        if backend == "auto":
            want["f32_launches"] = model.cfg.num_layers - 1
        if counts != want:
            raise RuntimeError(f"CLIP {backend}: launches {counts}, "
                               f"expected {want}")
    got, ref = feats["auto"], feats["plain"]
    if got.shape != (1, 257, 1280) or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"CLIP: features {tuple(got.shape)}, finite "
                           f"{bool(torch.isfinite(got).all())}")
    max_abs, rel = rel_err(got, ref)
    row = dict(blocks=model.cfg.num_layers - 1, max_abs_err=max_abs,
               rel_err=rel, kernel_s=secs["auto"], plain_s=secs["plain"],
               f32_launches=model.cfg.num_layers - 1)
    log("phase 12a: clip " + json.dumps(row))
    if rel > CLIP_REL_TOL:
        raise RuntimeError(f"CLIP kernel vs plain: {rel:.3e} of the "
                           f"features' scale > {CLIP_REL_TOL}")
    report["i2v_clip"] = row
    del model, feats, got, ref
    torch.cuda.empty_cache()


def phase_i2v_dit(report):
    """(b) The i2v-14B DiT at full width, 2 blocks, at the request's 7,800
    tokens with y and clip_fea: the kernel path against plain attention,
    then W8A8 against the plain int8 GEMM and quantization."""
    import torch

    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.models.wan_model import WanModel
    from moviigen_tpu_torch.ops import flash_attention as fa
    from moviigen_tpu_torch.ops import int8_gemm as ig

    cfg = WAN_CONFIGS[I2V_TASK].model.replace(num_layers=DIT_SMOKE_LAYERS)
    rows = {}
    for quant in (None, "w8a8"):
        gen = torch.Generator(device=DEVICE).manual_seed(12)
        model = WanModel(cfg, dtype=torch.bfloat16, device=DEVICE,
                         quant=quant).init_weights(gen)
        with torch.no_grad():
            model.head.weight.normal_(0.0, 0.02, generator=gen)  # live head
            args, cond = _i2v_dit_inputs(cfg, gen)
            fa.reset_launch_counts()
            ig.reset_launch_counts()
            got = model(*args, seq_len=7800, **cond).float()
            counts = {**fa.launch_counts(), **ig.launch_counts()}
            if quant is None:
                want = model(*args, seq_len=7800, attn_backend="plain",
                             **cond).float()
            else:
                with plain_int8_gemm():
                    want = model(*args, seq_len=7800, **cond).float()
        torch.cuda.synchronize()
        # per block: self-attention, text and image cross-attention; W8A8:
        # 12 linears (k_img and v_img too) in 8 quantized-input groups
        expected = dict.fromkeys(counts, 0)
        expected["launches"] = 3 * DIT_SMOKE_LAYERS
        if quant == "w8a8":
            expected.update(int8_gemm_launches=12 * DIT_SMOKE_LAYERS,
                            quantize_launches=8 * DIT_SMOKE_LAYERS)
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"i2v DiT {quant}: non-finite prediction")
        rel = float((got - want).norm() / want.norm())
        tag = quant or "bf16"
        rows[tag] = dict(layers=DIT_SMOKE_LAYERS, tokens=7800,
                         rel_norm_err=rel, pred_norm=float(want.norm()),
                         launches=counts)
        log(f"phase 12b: i2v dit {tag} " + json.dumps(rows[tag]))
        if rel > (DIT_REL_TOL if quant is None else QUANT_DIT_REL_TOL):
            raise RuntimeError(f"i2v DiT {tag}: kernel vs plain {rel:.3e}")
        if counts != expected:
            raise RuntimeError(f"i2v DiT {tag}: launches {counts}, "
                               f"expected {expected}")
        del model, got, want, args, cond
        torch.cuda.empty_cache()
    report["i2v_dit"] = rows


def phase_i2v_request(report):
    """(c) ``cli.generate --task i2v-14B --image`` at full width and depth:
    one 832×480×17 request, 4 UniPC steps, batched CFG."""
    import pathlib

    import torch
    from PIL import Image

    from moviigen_tpu_torch.cli import generate
    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.ops import flash_attention as fa
    from moviigen_tpu_torch.ops import int8_gemm as ig
    from moviigen_tpu_torch.pipelines.image2video import WanI2V

    out_dir = pathlib.Path(__file__).resolve().parent / "_smoke_out"
    out_dir.mkdir(exist_ok=True)
    png = out_dir / "i2v_first_frame.png"
    yy, xx = np.mgrid[0:480, 0:832]
    Image.fromarray(np.stack([xx * 255 // 831, yy * 255 // 479,
                              (xx + yy) % 256], -1).astype(np.uint8)
                    ).save(png)
    served = []
    real_generate = WanI2V.generate

    def recording_generate(pipe, *a, **k):
        video = real_generate(pipe, *a, **k)
        served.append((pipe.timings, video))
        return video

    cfg = WAN_CONFIGS[I2V_TASK]
    WanI2V.generate = recording_generate
    try:
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        ig.reset_launch_counts()
        t0 = time.perf_counter()
        out = generate.main([
            "--task", I2V_TASK, "--size", "832*480", "--frame_num",
            str(I2V_FRAMES), "--sample_steps", str(I2V_STEPS),
            "--base_seed", "42", "--image", str(png),
            "--save_file", str(out_dir / "i2v_832x480_17f.mp4")])
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        counts = {**fa.launch_counts(), **ig.launch_counts()}
    finally:
        WanI2V.generate = real_generate
    report["i2v_launches"] = counts
    (timings, video), = served
    # one batched-CFG forward per step: self, text and image attention in
    # each of the 40 blocks; the CLIP's 31 fp32 blocks once
    expected = dict.fromkeys(counts, 0)
    expected.update(launches=3 * cfg.model.num_layers * I2V_STEPS,
                    f32_launches=31)
    _serve_checks("i2v", video, I2V_FRAMES)
    row = dict(task=I2V_TASK, size="832*480", frames=I2V_FRAMES,
               steps=I2V_STEPS, tokens=7800, total_s=total_s,
               clip_s=timings["clip_s"], encode_s=timings["encode_s"],
               t5_s=timings["t5_s"], step_s=timings["step_s"],
               decode_s=timings["decode_s"],
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=counts, video_std=float(video.std()), saved=out)
    log("phase 12c: " + json.dumps(row))
    if counts != expected:
        raise RuntimeError(f"i2v request: launches {counts}, expected "
                           f"{expected}")
    if out is None or not os.path.getsize(out):
        raise RuntimeError("i2v request: no video written")
    report["i2v_request"] = row
    del served, video
    torch.cuda.empty_cache()


def phase_i2v_preprocess(report):
    """(d) ``cli.preprocess --dataset i2v`` on one synthetic 832×480×81
    clip: y and the CLIP features of its first frame beside the latent."""
    import pathlib
    import shutil

    import torch

    from moviigen_tpu_torch.cli import preprocess
    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.ops import flash_attention as fa
    from moviigen_tpu_torch.pipelines.image2video import build_i2v_mask

    cfg = WAN_CONFIGS[I2V_TASK]
    root = pathlib.Path(__file__).resolve().parent / "_smoke_out" / "pre_i2v"
    shutil.rmtree(root, ignore_errors=True)
    merge = _write_clips(root, [(PRE_FRAMES, PRE_FT_H, PRE_FT_W)], 2)
    out = root / "out"
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    out_json = preprocess.main([
        "--data_merge_path", merge, "--output_dir", str(out), "--task",
        I2V_TASK, "--dataset", "i2v", "--crop_height", str(PRE_FT_H),
        "--crop_width", str(PRE_FT_W)])
    run_s = time.perf_counter() - t0
    counts = fa.launch_counts()
    report["i2v_preprocess_launches"] = counts
    (item,) = json.loads(pathlib.Path(out_json).read_text())
    stats = json.loads((out / "preprocess_stats_shard0.json").read_text())
    y = np.load(out / "y" / item["y_path"])
    fea = np.load(out / "clip_feature" / item["clip_feature_path"])
    t_lat = (PRE_FRAMES - 1) // 4 + 1
    mask = build_i2v_mask(PRE_FRAMES, PRE_FT_H // 8, PRE_FT_W // 8).numpy()
    row = dict(task=I2V_TASK, frames=PRE_FRAMES,
               size=f"{PRE_FT_W}*{PRE_FT_H}", run_s=run_s,
               vae_s=stats["vae_s"], t5_s=stats["t5_s"],
               i2v_s=stats["i2v_s"], errors=stats["errors"],
               y_shape=list(y.shape), clip_feature_shape=list(fea.shape),
               launches=counts)
    log("phase 12d: " + json.dumps(row))
    if y.shape != (4 + cfg.vae.z_dim, t_lat, PRE_FT_H // 8, PRE_FT_W // 8) \
            or fea.shape != (257, 1280):
        raise RuntimeError(f"i2v preprocess: y {y.shape}, clip feature "
                           f"{fea.shape}")
    if not (np.isfinite(y).all() and np.isfinite(fea).all()):
        raise RuntimeError("i2v preprocess: non-finite y or clip feature")
    if not np.array_equal(y[:4], mask):
        raise RuntimeError("i2v preprocess: y[:4] is not the mask")
    if stats["errors"] or counts["f32_launches"] != 31:
        raise RuntimeError(f"i2v preprocess: errors {stats['errors']}, "
                           f"launches {counts}")
    report["i2v_preprocess"] = row
    shutil.rmtree(root)
    torch.cuda.empty_cache()


def phase_i2v(report):
    import gc

    import torch

    for sub in (phase_i2v_clip, phase_i2v_dit, phase_i2v_request,
                phase_i2v_preprocess):
        sub(report)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"phase 12: after {sub.__name__} "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")


PHASES = {1: phase_setup, 2: phase_kernels, 3: phase_dit,
          4: phase_main_path, 5: phase_profile, 6: phase_train,
          7: phase_train_profile, 8: phase_quant_serving,
          9: phase_quant_profile, 10: phase_preprocess, 11: phase_lora,
          12: phase_i2v}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,6,8,10,11,12",
                    help="comma-separated phases to run (default: all "
                         "but the profiles, 5, 7 and 9)")
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
