#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``moviigen_tpu_torch``) on one
NVIDIA Hopper card.

    python3 chip_smoke.py                 # every phase, as a release check
    python3 chip_smoke.py --phases 1,2    # build + kernel checks only

Phases:
 1. setup: card name and power limit, TF32 off, build the CUDA kernels
    (``flash_fwd``, ``flash_bwd``, ``int8_gemm``, ``quantize_act`` and
    ``flash_fwd_f32``, and the earlier designs of the forward, the int8
    GEMM (``mma.sync``) and the fp32 forward (fp32 FMAs) as their
    yardsticks, one ``nvcc`` each, in parallel);
 2. each kernel against its plain PyTorch version on the card, at the
    shapes of the serving (the i2v image cross-attention's 257 keys
    included), the CLIP's fp32 attention, the training and the W8A8 path,
    with times, bounds and the library yardsticks (the forward, its stats
    variant, the fp32 forward and the int8 GEMM also beside their design
    before the Hopper redesign, and with SM clock and power under load at
    the main shapes; the fp32 forward's µs-scale times are device times
    of single calls queued behind a spin of the card, medians of 200);
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
    synthetic 832×480×81 clip;
13. sequence-parallel serving, the mesh's ranks as threads of this
    process (``ThreadComm``; NCCL puts no two ranks on one card): (a) the
    t2v-14B DiT at full width and depth, r1's shape, one forward each in
    Ulysses sp 2 and 4, ring sp 2 and USP 2 × 2 bit-equal to the
    one-process forward, launches counted, seconds beside the one-process
    forward's;
    (b) the kernels at the shapes those modes launch, against their plain
    twins on the same inputs: the forward over Ulysses' N/sp heads and on
    the cross-attention's query shards, the ring itself over thread ranks
    (r1's tokens padded to whole key tiles a shard, the shards walked in
    natural order) against one card's kernel over the unpadded keys, its
    largest difference and differing elements counted, and the ring's
    carried kernel per (query shard, key shard) step at ring sp 2's 40
    heads, USP's 20 (and at 4 shards) against the one-shot kernel, and
    with an empty key shard
    against the plain twin step by step, timed beside the stats kernel
    and the eager merge the ring ran before; (c) the
    FSDP variant at sp 2 (block weights as shards gathered per block; a
    4-block bf16 and W8A8 DiT, a 4-layer umT5-XXL) bit-equal to the
    unsharded one; (d) ``cli.generate --dit_fsdp --t5_fsdp`` under
    torchrun's variables for one rank, NCCL at world size 1, over 8b's
    directory, equal to the run without the flags;
14. the host utilities and the apps: (a) ``cli.finetune`` for t2v-1.3B
    as in 6b with ``--profile_steps 2``, every batch read through the
    native reader pool, the Chrome trace holding 2 steps' stats-forward,
    dKV and dQ launches, device ms by category, then 6b's dataset through
    the loader with and without the pool, bit-equal; (b) the umT5-XXL
    decoder at full width (2 layers) in fp32 on the card against the CPU,
    and in bf16; (c) the gradio app (gradio stubbed) over 8b's directory:
    two 832×480×17 requests equal to ``WanT2V.generate``'s, Prompt
    Enhance offline giving the prompt back; (d) ``cli.generate
    --use_prompt_extend`` with each rewriter failing, the video unchanged;
15. (only when asked: ``--phases 15``) 11a's QLoRA run with
    ``--profile_steps 2``: device ms by category and the top 40 kernels;
16. sequence-parallel training on the one card, the ranks as threads:
    (a) the ring's pair kernels (carried forward, stats forward, dKV, dQ)
    at 32,760 tokens cut in two, at 12 and 40 heads, with the global
    stats of the ring's carried forward and an empty key shard, against
    their plain twins,
    their sums against the one-shot backward, timed beside their bounds
    and SDPA's forward + backward; (b) cell st1: one t2v-1.3B train step
    at full width and depth and 32,760 tokens in Ulysses sp 2, ring sp 2
    and USP 2 × 2 (block weights as shards gathered per block, remat)
    against the one-process step, launches counted, seconds and peak GiB;
    (c) ``cli.finetune --sp_size 1`` over NCCL at world size 1, 2 steps,
    its mesh checkpoint read back; (d) the 14B QLoRA step (int8 base,
    depth cut) in Ulysses sp 2 against one process, the base bit-equal;
17. (only when asked: ``--phases 17``; four cards) the runs of
    ``tools/sp_serve_cards.py`` (the 14B served over 4 ranks, one per
    card over NCCL: Ulysses with per-block gathers, ring, USP, data 2 ×
    seq 2, int4 and W8A8, ``scripts/inference.sh``'s 1280×720×81
    request, the 1920×832×81 one in Ulysses and ring, i2v, and one card
    against itself with its keys rolled) and of
    ``tools/sp_train_cards.py`` (``finetune --sp_size 4`` of the 14B in
    full, the SP step in Ulysses, ring and USP against one
    card, data 2 × seq 2 with accumulation, a stop and a resume), each
    against one card; raises with fewer than four cards;
18. the kernels at the shapes those four-card runs launch on each rank,
    on this one card, against their plain twins: the forward (S4's half
    CFG pair, S6's 75,600 tokens over 10 heads and its 18,900-row cross
    shard, S7's 131,040 tokens over 10 heads, S8's image cross-attention
    on 1,950- and 18,900-row shards), the ring's carried step at S7's
    32,768-key shards, the stats forward, dKV and dQ of T1-T5 (10, 6 and
    3 heads over 32,760 tokens; the 8,190- and 16,380-row cross shards), the ring's
    pairs of 4 and 2 key shards at 12, 6, 40 and 20 heads with an empty
    shard, the int8 GEMM and the activation quantization at S5's 3,900
    rows.

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
# The fp32 forward's first design (fp32 FMAs, loads between barriers), the
# same kind of yardstick for its 3xTF32 redesign.
F32_BEFORE = "flash_fwd_f32_simple"
F32_BEFORE_SOURCE = FWD_BEFORE_SOURCE.parent / f"{F32_BEFORE}.cu"
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
PEAK_TF32_FLOPS = 495e12
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
# inside the last key tile. The plain twin is full fp32 (TF32 off); the
# kernel's 3xTF32 products drop ~2^-21 of each product, and the two sum in
# another order: a few fp32 ulps of the output's scale. 1e-5 of it bounds
# that; a wrong tile, mask or scale is off by O(1), and one TF32 pass (a
# dropped split) by ~5e-4.
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
# A spin of the card (torch.cuda._sleep, ~1 ms at the H100's clocks) queued
# before each timed call of a µs-scale kernel, so that the call's host
# share is hidden and its events bracket only its kernels.
FENCE_CYCLES = 2_000_000


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


def device_times(fn, iters, warmup=10):
    """Device milliseconds of ``iters`` single calls of ``fn`` (CUDA
    events), each queued behind a ``FENCE_CYCLES`` spin of the card that
    outlasts the host's share of the call: the events bracket only the
    call's kernels, where ``cuda_ms`` also counts the host's launch."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(FENCE_CYCLES)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in pairs]


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


def carry_bound(b, lq, lk, n, d=HEAD_DIM):
    """(bound ms, bound_by) of a middle step of the ring's carried forward
    (``flash_fwd.cu`` ``kCarry``, neither first nor last): the forward's
    flops over every key, q, k and v read once, and the fp32 state (acc
    [B, Lq, N, D]; m, l [B, N, Lq]) read once and written once."""
    state = 4 * b * lq * n * d + 2 * 4 * b * n * lq
    return _bound(4.0 * n * lq * d * b * lk,
                  2 * n * d * (b * lq + 2 * b * lk) + 2 * state)


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
    secs = kernels.build(
        kernels.KERNELS + (FWD_BEFORE, GEMM_BEFORE, F32_BEFORE),
        {FWD_BEFORE: FWD_BEFORE_SOURCE, GEMM_BEFORE: GEMM_BEFORE_SOURCE,
         F32_BEFORE: F32_BEFORE_SOURCE})
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
    against its plain twin (TF32 off), with its bound on the path it takes
    (3xTF32 at the TF32 peak, beside the fp32-FMA and byte bounds), its
    first design (``F32_BEFORE``) and fp32 SDPA as the library yardstick.
    Device times (``device_times``): the kernel and its first design take
    turns (kernel, first, first, kernel), 100 calls each, the median of
    200; also the single-call time with the host's launch (``cuda_ms``,
    the method of the rows before the redesign)."""
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
        flops = 4.0 * n * lq * d * keys
        nbytes = 4.0 * n * d * (2 * b * lq + 2 * keys)
        bound_ms, bound_by = _bound(3 * flops, nbytes,
                                    peak_ops=PEAK_TF32_FLOPS)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = None
        if k_lens is not None:
            mask = (torch.arange(lk, device=DEVICE)[None, :]
                    < k_lens[:, None])[:, None, None, :]

        def kernel():
            return fa.flash_attention_f32_cuda(q, k, v, k_lens)

        times = {"kernel": [], "before": []}
        for which in ("kernel", "before", "before", "kernel"):
            if which == "kernel":
                times[which] += device_times(kernel, 100)
            else:
                with before_redesign("flash_fwd_f32", F32_BEFORE_SOURCE):
                    times[which] += device_times(kernel, 100)
        ms = statistics.median(times["kernel"])
        with before_redesign("flash_fwd_f32", F32_BEFORE_SOURCE):
            before_call_ms = cuda_ms(kernel, iters=200, warmup=20)
        row = dict(case=name, B=b, Lq=lq, Lk=lk, N=n, D=d, k_lens=lk_eff,
                   max_abs_err=max_abs, rel_err=rel, ms=ms,
                   before_redesign_ms=statistics.median(times["before"]),
                   plain_ms=statistics.median(device_times(
                       lambda: fa.flash_attention_plain(q, k, v, k_lens),
                       200)),
                   library_ms=statistics.median(device_times(
                       lambda: sdpa(qt, kt, vt, attn_mask=mask), 200)),
                   library="SDPA fp32",
                   call_ms=cuda_ms(kernel, iters=200, warmup=20),
                   before_redesign_call_ms=before_call_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   bound_fp32_fma_ms=flops / PEAK_FP32_FLOPS * 1e3,
                   bytes_ms=nbytes / PEAK_HBM_BYTES * 1e3)
        row["bound_share"] = bound_ms / ms
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


def _check_carry(name, got, want):
    """A step of the ring's carried forward against its plain twin's: acc
    (or, on the last step, out), m and l within ``FLASH_REL_TOL``; rows
    that have attended to nothing yet must be exactly m = -1e30, l = 0 and
    acc (out) = 0 in the kernel's result, as in the twin's, and are left
    out of m's bound. Returns the (max abs, relative) errors."""
    import torch

    empty = want[1] <= -0.99e30
    if not torch.equal(empty, got[1] <= -0.99e30) \
            or bool(got[1][empty].ne(-1e30).any()) \
            or bool(got[2][empty].any()) \
            or bool(got[0].transpose(1, 2)[empty].any()):
        raise RuntimeError(f"{name}: rows that attended to nothing are not "
                           "m = -1e30, l = 0, acc = 0")
    errs = [_check(name, "acc or out", got[0], want[0], FLASH_REL_TOL),
            _check(name, "l", got[2], want[2], FLASH_REL_TOL)]
    if not bool(empty.all()):
        errs.append(_check(name, "m", got[1][~empty], want[1][~empty],
                           FLASH_REL_TOL))
    return errs


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


def int8_kernel_cases(report, cases=None, key="int8_cases", phase="2"):
    """The int8 GEMM at the W8A8 path's shapes, in its three bias modes,
    against its plain version (bit for bit), beside its design before the
    Hopper redesign; then the activation-quantization kernel. Yardsticks
    the port never calls: ``torch._int_mm`` plus the eager rescale (the
    library's route to the same function) and the bf16 ``F.linear`` of
    the same layer (what W8A8 competes with). With ``cases``: the same at
    other shapes, rows in ``report[key]``."""
    import torch
    import torch.nn.functional as F

    from moviigen_tpu_torch.ops import int8_gemm as ig
    from moviigen_tpu_torch.ops.quantization import (dequantize_leaf,
                                                     quantize_activations,
                                                     quantize_linear_int4)

    rows = []
    for i, (name, m, k, n) in enumerate(cases or INT8_CASES):
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
            log(f"phase {phase}: int8 {name}: torch._int_mm refused: {e}")
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
        log(f"phase {phase}: int8 " + json.dumps(row))
        rows.append(row)
        del x, xq, sx, wq, wt, wb
        torch.cuda.empty_cache()
    report[key] = rows
    if cases is None:
        quantize_kernel_cases(report)


def quantize_kernel_cases(report, cases=None, key="quantize_cases",
                          phase="2"):
    """The activation-quantization kernel at the W8A8 path's shapes (or
    ``cases``) against its plain version (bit for bit). No single PyTorch
    call computes this function, so there is no library yardstick."""
    import torch

    from moviigen_tpu_torch.ops import quantization as tq

    rows = []
    for i, (m, k) in enumerate(cases or QUANT_CASES):
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
        log(f"phase {phase}: quantize " + json.dumps(row))
        rows.append(row)
        del x, got_q, got_s, want_q, want_s
        torch.cuda.empty_cache()
    report[key] = rows


def _sp_launches(report, key):
    """A kernel's launches in each SP mode's forward of phase 13a."""
    modes = report.get("sp_forward", {}).get("modes", {})
    return {f"sp {name} (phase 13a)": row["launches"].get(key, 0)
            for name, row in modes.items()}


def _spt_launches(report, key):
    """A training kernel's launches in phase 16's SP train steps: each
    mode's timed st1 step (16b), the 2-step ``cli.finetune --sp_size 1``
    run (16c) and the 14B QLoRA step (16d)."""
    modes = {k: v for k, v in report.get("sp_train", {}).items()
             if k != "one_process"}
    out = {f"sp train st1 {name} (phase 16b)": row["launches"].get(key, 0)
           for name, row in modes.items()}
    if "sp_train_cli" in report:
        out["finetune --sp_size 1, 2 steps (phase 16c)"] = \
            report["sp_train_cli"]["launches"].get(key, 0)
    if "sp_train_qlora" in report:
        out["14B QLoRA sp 2 (phase 16d)"] = \
            report["sp_train_qlora"]["launches"].get(key, 0)
    return out


def kernels_line(report):
    cases = report["flash_cases"] \
        + report.get("sp_kernels", {}).get("fwd", []) \
        + report.get("cards_kernels", {}).get("fwd", [])
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
                "launches", 0),
            **_sp_launches(report, "launches"),
            **_cards_launches(report, "launches"),
            "gradio app requests (phase 14c)": report.get(
                "app_launches", {}).get("launches", 0),
            "generate --use_prompt_extend (phase 14d)": report.get(
                "extend_launches", {}).get("launches", 0)},
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
            "design": "3xTF32 on mma.sync m16n8k8 tensor cores, a 2-stage "
                      "cp.async K/V ring of 64-key tiles, 32-row blocks of "
                      "2 x 2 warps (two key slices merged at the end)",
            "ms": main32["ms"],
            "before_redesign_ms": main32["before_redesign_ms"],
            "plain_ms": main32["plain_ms"],
            "bound_ms": main32["bound_ms"], "bound_by": main32["bound_by"],
            "bound_share": main32["bound_share"],
            "library_ms": main32["library_ms"],
            "cases": f32,
        })
    int8 = report.get("int8_cases", []) + report.get("cards_int8", [])
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
                        "int8_gemm_launches", 0),
                "w8a8 fsdp sp2 (phase 13c)": report.get("sp_fsdp", {}).get(
                    "w8a8", {}).get("launches", {}).get(
                        "int8_gemm_launches", 0),
                **_cards_launches(report, "int8_gemm_launches")},
            "max_abs_err": max(c["max_abs_err"] for c in int8),
            "ms": main8["ms"],
            "before_redesign_ms": main8["before_redesign_ms"],
            "plain_ms": main8["plain_ms"],
            "bound_ms": main8["bound_ms"], "bound_by": main8["bound_by"],
            "library_ms": main8["library_ms"],
            "bf16_linear_ms": main8["bf16_linear_ms"],
            "cases": int8,
        })
        quant = report.get("quantize_cases", []) \
            + report.get("cards_quantize", [])
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
                        "quantize_launches", 0),
                "w8a8 fsdp sp2 (phase 13c)": report.get("sp_fsdp", {}).get(
                    "w8a8", {}).get("launches", {}).get(
                        "quantize_launches", 0),
                **_cards_launches(report, "quantize_launches")},
            "max_abs_err": max(c["max_abs_err"] for c in quant),
            "ms": mainq["ms"], "plain_ms": mainq["plain_ms"],
            "bound_ms": mainq["bound_ms"], "bound_by": mainq["bound_by"],
            "library_ms": None, "library": mainq["library"],
            "cases": quant,
        })
    train = report.get("train_cases", []) + report.get("train14_cases", [])
    counts = report.get("train_launches", {})

    def by_path(key):
        return {"ft (phase 6b)": counts.get(key, 0),
                "qlora (phase 11a)": report.get("qlora_launches", {}).get(
                    key, 0),
                "ot (phase 11d)": report.get("ot_launches", {}).get(key, 0),
                "ft profiled (phase 14a)": report.get(
                    "ft_profile_launches", {}).get(key, 0),
                "qlora profiled (phase 15)": report.get(
                    "qlora_profile_launches", {}).get(key, 0)}

    stats = [c for c in train if "kernel" in c]
    bwd = [c for c in train if "kernel" not in c]
    pairs = report.get("sp_train_pairs", []) \
        + report.get("cards_kernels", {}).get("train", [])
    # the ring's carried forward: 13b's ring groups of the SP modes, 18's
    # step at S7's ring shards, 16a's pairs, 18's four-card shapes
    carry = report.get("sp_kernels", {}).get("carry", []) \
        + report.get("cards_kernels", {}).get("carry", []) + [dict(
        case=c["case"], kernel="carry", N=c["N"], shards=c["shards"],
        max_abs_err=c["carry_max_abs_err"], rel_err=c["carry_rel_err"],
        ms=c["carry_ms"], plain_ms=c["carry_plain_ms"],
        bound_ms=c["carry_bound_ms"], bound_by=c["carry_bound_by"],
        library_ms=c["stats_library_ms"], library=c["stats_library"],
        stats_ms=c["stats_ms"]) for c in pairs if "carry_ms" in c]
    if carry:
        mc = carry[0]  # 13b's ring sp 2 pair when phase 13 ran
        entries.append({
            "name": "flash_fwd_carry",
            "route": "cuda",
            "source": "moviigen_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "moviigen_tpu/ops/flash_attention.py:105",
            "launches": sum(_sp_launches(report, "carry_launches").values()),
            "launches_by_path": {
                **_sp_launches(report, "carry_launches"),
                **_spt_launches(report, "carry_launches"),
                **_cards_launches(report, "carry_launches")},
            "max_abs_err": max(c["max_abs_err"] for c in carry),
            "ms": mc["ms"], "plain_ms": mc["plain_ms"],
            "bound_ms": mc["bound_ms"], "bound_by": mc["bound_by"],
            "library_ms": mc["library_ms"], "cases": carry,
        })
    # 16a: the ring's pairs; 18: the four-card runs' shapes
    for c in pairs:
        stats.append(dict(
            case=c["case"], kernel="stats", N=c["N"],
            max_abs_err=c["stats_max_abs_err"], rel_err=c["stats_rel_err"],
            ms=c["stats_ms"], plain_ms=c["stats_plain_ms"],
            bound_ms=c["stats_bound_ms"], bound_by=c["stats_bound_by"],
            library_ms=c["stats_library_ms"], library=c["stats_library"],
            before_redesign_ms=None))
        bwd.append(c)
    if not stats or not bwd:
        return {"kernels": entries}
    # self-attention at 32,760 tokens: the 1.3B row (N = 12) when phase 2
    # ran, else the 14B one (N = 40)
    s, bmain = stats[0], bwd[0]
    entries.append({
        "name": "flash_fwd_stats",
        "route": "cuda",
        "source": "moviigen_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "moviigen_tpu/ops/flash_attention.py:105",
        "launches": counts.get("stats_launches", 0),
        "launches_by_path": {**by_path("stats_launches"),
                             **_sp_launches(report, "stats_launches"),
                             **_spt_launches(report, "stats_launches"),
                             **_cards_launches(report, "stats_launches")},
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
            "launches_by_path": {
                **by_path(f"{key}_launches"),
                **_spt_launches(report, f"{key}_launches"),
                **_cards_launches(report, f"{key}_launches")},
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
    if "flash_fwd" in name:
        # flash_fwd.cu's template Variant: 1 the stats variant, 2 the
        # ring's carried one (demangled or mangled names)
        variant = re.search(r"Variant\)(\d)>|VariantE(\d)E", name)
        kind = {"1": " stats", "2": " carried"}.get(
            variant and (variant.group(1) or variant.group(2)), "")
        return f"flash forward{kind} (this port's kernel)"
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

    from moviigen_tpu_torch.utils.profiling import device_kernels

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
    return kernel_summary(device_kernels(prof), phase, shape=label,
                          wall_ms=wall_ms,
                          wall_ms_unprofiled=wall_ms_unprofiled)


def kernel_summary(kernels, phase, **head):
    """``head`` with the device ms and launches by ``_kernel_category`` of
    a profiler's ``{kernel: (launches, ms)}`` (``utils.profiling.
    device_kernels``) and, given ``wall_ms``, the device's idle share;
    logged with the top 40 kernels."""
    rows = sorted(((name, ms, count) for name, (count, ms)
                   in kernels.items()), key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    cats, launches = {}, {}
    for name, ms, count in rows:
        cat = _kernel_category(name)
        cats[cat] = cats.get(cat, 0.0) + ms
        launches[cat] = launches.get(cat, 0) + count
    summary = dict(head, device_ms=device_ms)
    if "wall_ms" in head:
        summary["idle_share"] = (1.0 - device_ms / head["wall_ms"]) \
            if rows else None
    summary.update(categories_ms=cats, categories_launches=launches)
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
    from moviigen_tpu_torch.utils.safetensors import load_file, read_metadata

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
    saved_opt = load_file(str(path / OPT_FILE))
    read_s = time.perf_counter() - t0
    for name, p in model.named_parameters():
        if not torch.equal(saved[name], p.detach().cpu()):
            raise RuntimeError(f"checkpoint: {name} read back differs")
    state = opt.state_dict()
    counts = read_metadata(str(path / OPT_FILE))
    if (int(counts["count"]), int(counts["mini_step"])) != (
            state["count"], state["mini_step"]):
        raise RuntimeError("checkpoint: optimizer counts read back differ")
    for key in ("m", "v"):  # the optimizer's params are the model's
        for (name, _), b in zip(model.named_parameters(), state[key]):
            if not torch.equal(saved_opt[f"{key}/{name}"], b.cpu()):
                raise RuntimeError(f"checkpoint: optimizer {key} of {name} "
                                   "differs")
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


def _cut_task():
    """Register ``CKPT_TASK`` (t2v-14B at full width, its depth cut) with
    the port's configs, in this process; returns its config."""
    from moviigen_tpu_torch import configs

    base = configs.WAN_CONFIGS["t2v-14B"]
    cfg = base.replace(
        name=CKPT_TASK,
        model=base.model.replace(num_layers=CKPT_DIT_LAYERS),
        t5=base.t5.replace(num_layers=CKPT_T5_LAYERS))
    configs.WAN_CONFIGS[CKPT_TASK] = cfg
    configs.SUPPORTED_SIZES[CKPT_TASK] = configs.SUPPORTED_SIZES["t2v-14B"]
    return cfg


def _export_ckpt_dir(root, phase):
    """A random ``CKPT_TASK`` checkpoint directory in the reference layout
    under ``root``, written by the port's exporters (the DiT in fp32, the
    umT5 in bf16, the VAE). Returns (directory, its config, the first
    block's fc1 weight in bf16, GiB, seconds)."""
    import shutil

    import torch

    from moviigen_tpu_torch.models import t5 as t5m
    from moviigen_tpu_torch.models import vae as vaem
    from moviigen_tpu_torch.models import vae_convert, wan_convert
    from moviigen_tpu_torch.models.wan_model import WanModel

    cfg = _cut_task()
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
    del dit
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
    log(f"phase {phase}: exported a random {CKPT_TASK} checkpoint directory "
        f"({ckpt_gib:.2f} GiB) in {export_s:.1f} s")
    return ckpt, cfg, fc1, ckpt_gib, export_s


def phase_ckpt_dir_serving(report):
    """(b) ``cli.generate --ckpt_dir --quant int8`` as a user runs it,
    twice, over a random checkpoint directory in the reference layout
    that the port's exporters write first: the first start quantizes and
    writes the caches, the second must start from them alone. The
    directory stays for phases 13d and 14 when they run too."""
    import pathlib
    import shutil

    import torch

    from moviigen_tpu_torch.cli import generate
    from moviigen_tpu_torch.ops import flash_attention as fa
    from moviigen_tpu_torch.ops import int8_gemm as ig
    from moviigen_tpu_torch.ops.quantization import quantize_linear
    from moviigen_tpu_torch.pipelines import text2video as t2v

    root = pathlib.Path(__file__).resolve().parent / "_smoke_out" / "serve"
    ckpt, cfg, fc1, ckpt_gib, export_s = _export_ckpt_dir(root, "8b")
    want_q, want_s = quantize_linear(fc1)
    del fc1

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
    if report.get("ckpt_keepers"):
        report["ckpt_dir_path"] = ckpt
    else:
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
    from moviigen_tpu_torch.utils.safetensors import load_file, read_metadata

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
    state = load_file(str(path / ck.OPT_FILE))
    mine = opt.state_dict()
    place = {id(p): i for i, p in enumerate(opt.params)}
    if int(read_metadata(str(path / ck.OPT_FILE))["count"]) != LORA_STEPS \
            or not all(torch.equal(state[f"{key}/{name}"],
                                   mine[key][place[id(t)]].cpu())
                       for key in ("m", "v") for name, t in named.items()):
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

    memory = report.setdefault("i2v_memory_gib", {})
    for sub in (phase_i2v_clip, phase_i2v_dit, phase_i2v_request,
                phase_i2v_preprocess):
        sub(report)
        # what the sub-phase left behind, before and after the cyclic
        # collector: the two agree unless something outlives its scope in
        # a reference cycle
        before = torch.cuda.memory_allocated() / 2**30
        gc.collect()
        torch.cuda.empty_cache()
        after = torch.cuda.memory_allocated() / 2**30
        memory[sub.__name__] = dict(before_collect=before,
                                    after_collect=after)
        log(f"phase 12: after {sub.__name__} {before:.2f} GiB allocated "
            f"before gc.collect(), {after:.2f} after")



# Phase 13: sequence-parallel serving on the one card, the mesh's ranks as
# threads of this process (``parallel.comm.ThreadComm``: NCCL puts no two
# ranks on one GPU). (name, sp_mode, data, ring, seq), at r1's shape.
SP_CASES = [
    ("ulysses_sp2", "ulysses", 1, 1, 2),
    ("ulysses_sp4", "ulysses", 1, 1, 4),
    ("ring_sp2", "ring", 1, 1, 2),
    ("usp_r2_u2", "usp", 1, 2, 2),
]
# The SP forward against the one-process forward, bf16 compute, 40 blocks.
# Ulysses runs each head's attention as the same kernel work item over the
# same keys, and the linears' rows are independent of each other: it must
# give the one-process bits exactly. The ring carries its online softmax
# through the kernel in fp32 and rounds each output once, as one card
# does; it walks the key shards in natural order on whole 128-key tiles
# (the sequence padded to a multiple of 128 · sp) and carries each kernel
# thread's share of l, so it too gives the one-process bits. Any smaller
# difference is no help: one bf16 step in 2e-5 of the attention's
# outputs grows to 2.2e-3 of the prediction's norm through the 40 blocks.
# The bound below is the controls' yardstick (``SP_CONTROLS``): a fault
# of the SP code runs in every block, and one head dropped in every block
# must read above it; one head dropped in block 0 alone reads less, so a
# fault that small is left to 13b's step-by-step checks of the ring.
SP_RING_REL_TOL = 5e-3
# (name, blocks, must exceed the bound): the one-process forward with
# head 0 of those blocks' self-attention dropped (its input columns of
# the o-projection zeroed), against the intact forward
SP_CONTROLS = (("head 0 of block 0 dropped", (0,), False),
               ("head 0 of every block dropped", None, True))
# the modes whose forward 13a also profiles (the one-process one too)
SP_PROFILED = ("ulysses_sp4", "usp_r2_u2")
# 13b: r1's attention (B = 2, 7,800 tokens, 40 heads) cut as the modes of
# SP_CASES cut it, plus ring 4 (heads, key shards, sequence axes), which
# no 13a mode runs.
SP_SHAPE = (2, 7800, HEADS)
SP_RING_EXTRA = ((HEADS, 4, 4),)
# 13c: the FSDP variant at full width with the depth cut (the full-depth
# DiT is 13a's); 13d: world size 1 over NCCL on 8b's directory.
SP_FSDP_LAYERS, SP_FSDP_T5_LAYERS = 4, 4


def _sp_expected(mode, ring, sp, layers):
    """Launches of one SP forward over all ranks: per block and rank one
    cross-attention forward (its token shard against the 512 text keys)
    and, for the self-attention, one forward over N/sp heads (ulysses) or
    one carried launch per key shard that comes round the ring (ring: sp;
    usp: R); no stats launch."""
    shards = {"ulysses": 0, "ring": sp, "usp": ring}[mode]
    return dict(launches=layers * sp * (1 + (mode == "ulysses")),
                carry_launches=layers * sp * shards)


def phase_sp_forward(report):
    """(a) The t2v-14B DiT at full width and depth, random weights with a
    live head, at r1's shape (7,800 tokens, B = 2): the one-process
    forward, then each SP mode of ``SP_CASES`` over thread ranks (one
    untimed forward, then one timed with its launches counted); then the
    device's busy time and idle share under torch.profiler for the
    one-process forward and ``SP_PROFILED`` (do the thread ranks keep the
    card busy, or does the host hold it back?)."""
    import torch

    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.models.wan_model import WanModel
    from moviigen_tpu_torch.ops import flash_attention as fa
    from moviigen_tpu_torch.parallel.comm import run_ranks, thread_mesh
    from moviigen_tpu_torch.parallel.ulysses import sequence_parallel_forward

    cfg = WAN_CONFIGS["t2v-14B"].model
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    t0 = time.perf_counter()
    model = WanModel(cfg, dtype=torch.bfloat16, device=DEVICE)
    model.init_weights(gen)
    with torch.no_grad():
        model.head.weight.normal_(0.0, 0.02, generator=gen)  # live head
    x, t, ctx, rope = _dit_inputs(cfg, gen)
    torch.cuda.synchronize()
    log(f"phase 13a: t2v-14B DiT built in {time.perf_counter() - t0:.1f} s")
    rows = {}
    with torch.no_grad():
        model(x, t, ctx, rope, seq_len=7800)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = model(x, t, ctx, rope, seq_len=7800).float()
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        log(f"phase 13a: one-process forward {one_s:.3f} s")
        for name, mode, data, ring, seq in SP_CASES:
            def fwd(comm):
                return sequence_parallel_forward(
                    model, x, t, ctx, rope, comm, seq_len=7800,
                    sp_mode=mode)

            run_ranks(fwd, thread_mesh(data=data, ring=ring, seq=seq))
            torch.cuda.synchronize()
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            outs = run_ranks(fwd, thread_mesh(data=data, ring=ring,
                                              seq=seq))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = fa.launch_counts()
            sp = ring * seq
            expected = dict.fromkeys(counts, 0)
            expected.update(_sp_expected(mode, ring, sp, cfg.num_layers))
            got = outs[0].float()
            if not bool(torch.isfinite(got).all()):
                raise RuntimeError(f"sp {name}: non-finite prediction")
            if not all(torch.equal(o, outs[0]) for o in outs[1:]):
                raise RuntimeError(f"sp {name}: the ranks disagree")
            rel = float((got - want).norm() / want.norm())
            rows[name] = dict(
                sp_mode=mode, data=data, ring=ring, seq=seq, s=secs,
                one_process_s=one_s, rel_norm_err=rel,
                rel_max_err=float((got - want).abs().max()
                                  / want.abs().max()),
                bound="bit-equal",
                launches=counts,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            log(f"phase 13a: {name} " + json.dumps(rows[name]))
            # every mode: Ulysses splits the work items by head, the ring
            # walks the keys on one card's tiles and in its order
            if not torch.equal(got, want):
                raise RuntimeError(f"sp {name}: not bit-equal to the "
                                   f"one-process forward ({rel:.3e})")
            if counts != expected:
                raise RuntimeError(f"sp {name}: launches {counts}, "
                                   f"expected {expected}")
            del outs, got
        controls = {}
        for what, blocks, must in SP_CONTROLS:
            ws = [model.blocks[i].self_attn.o.weight[:, :cfg.head_dim]
                  for i in (blocks or range(cfg.num_layers))]
            kept = [w.clone() for w in ws]
            for w in ws:
                w.zero_()
            controls[what] = float((model(x, t, ctx, rope, seq_len=7800)
                                    .float() - want).norm() / want.norm())
            for w, k in zip(ws, kept):
                w.copy_(k)
            del ws, kept
            log(f"phase 13a: control, {what}: {controls[what]:.3e} of the "
                f"norm (bound {SP_RING_REL_TOL})")
            if must and controls[what] <= SP_RING_REL_TOL:
                raise RuntimeError(f"sp control, {what}: "
                                   f"{controls[what]:.3e} is within the "
                                   f"ring's bound {SP_RING_REL_TOL}")
        profiles = {"one_process": profile(
            lambda: model(x, t, ctx, rope, seq_len=7800), "one_process",
            "13a")}
        for name, mode, data, ring, seq in SP_CASES:
            if name in SP_PROFILED:
                mesh = dict(data=data, ring=ring, seq=seq)
                profiles[name] = profile(
                    lambda: run_ranks(lambda c: sequence_parallel_forward(
                        model, x, t, ctx, rope, c, seq_len=7800,
                        sp_mode=mode), thread_mesh(**mesh)), name, "13a")
    report["sp_forward"] = dict(
        one_process_s=one_s, modes=rows, pred_norm=float(want.norm()),
        controls_rel_norm_err=controls,
        profiles={k: {f: v[f] for f in ("wall_ms", "wall_ms_unprofiled",
                                         "device_ms", "idle_share")}
                  for k, v in profiles.items()})
    del model, want
    torch.cuda.empty_cache()


def _sp_kernel_shapes():
    """The attention the modes of ``SP_CASES`` launch at r1's shape:
    Ulysses' forward over N/sp heads and all L tokens (the head counts),
    the ring groups of ring and USP as (heads, key shards, sequence
    axes' size sp: the tokens are padded to a multiple of 128 · sp) with
    ``SP_RING_EXTRA``, and the cross-attention's query shards (L/sp rows,
    of the length ring and USP pad to, against the 512 text keys)."""
    from moviigen_tpu_torch.parallel.ulysses import sp_seq_len

    _, l, n = SP_SHAPE
    heads, rings, rows = set(), set(SP_RING_EXTRA), set()
    for _, mode, _, ring, seq in SP_CASES:
        rows.add(sp_seq_len(l, ring * seq, mode) // (ring * seq))
        if mode == "ulysses":
            heads.add(n // seq)
        elif mode == "ring":
            rings.add((n, seq, seq))
        else:
            rings.add((n // seq, ring, ring * seq))
    return sorted(heads), sorted(rings), sorted(rows)


def _sp_fwd_case(name, q, k, v, plain_iters=3):
    """The forward kernel against its plain twin on the same inputs, with
    its time, the plain twin's (median of ``plain_iters``), SDPA's and the
    bound."""
    import torch

    from moviigen_tpu_torch.ops import flash_attention as fa

    b, lq, n, _ = q.shape
    lk = k.shape[1]
    got = fa.flash_attention_cuda(q, k, v)
    want = fa.flash_attention_plain(q, k, v)
    max_abs, rel = _check(name, "out", got, want, FLASH_REL_TOL)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    bound_ms, bound_by = flash_bound(b, lq, [lk] * b, n=n)
    return dict(case=name, B=b, Lq=lq, Lk=lk, N=n, max_abs_err=max_abs,
                rel_err=rel,
                ms=cuda_ms(lambda: fa.flash_attention_cuda(q, k, v)),
                plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v),
                                 iters=plain_iters,
                                 warmup=min(1, plain_iters - 1)),
                library_ms=cuda_ms(lambda: torch.nn.functional
                                   .scaled_dot_product_attention(qt, kt,
                                                                 vt)),
                bound_ms=bound_ms, bound_by=bound_by,
                before_redesign_ms=None)


def _sp_ring_case(n, shards, sp, gen):
    """The ring of ``shards`` key shards at ``n`` heads over r1's 7,800
    tokens padded as ring and USP over ``sp`` ranks pad them
    (``sp_seq_len``: 7,936 at ring 2, 8,192 at sp 4; shards of whole key
    tiles). First the path itself: ``ring_self_attention`` over
    thread ranks with the pad masked, against the one-shot kernel over
    the 7,800 keys unpadded, as one card runs it: the largest difference
    and the count of elements that differ (the shards walked in natural
    order on 128-key boundaries leave only the order of l's sums). Then
    for each query shard the carried kernel on each key shard in natural
    order (its local ``k_lens``): dense against the one-shot kernel, then
    with a ``k_lens`` that empties batch entry 1's last key shard against
    the plain twin, each step against the twin's step
    (``_check_carry``), the empty shard's step passing entry 1's state
    through bit for bit. A middle step at the grid the ring launches
    while a shift is in flight against the full grid's, bit for bit
    (``_spare_grid``), and timed (state read and written) with its plain
    twin, SDPA and its bound, beside what the ring once ran in its place:
    the stats kernel and ``ring.ring_merge``'s eager merge."""
    import torch

    from moviigen_tpu_torch.ops import flash_attention as fa
    from moviigen_tpu_torch.parallel import ring
    from moviigen_tpu_torch.parallel.comm import run_ranks, thread_mesh
    from moviigen_tpu_torch.parallel.ulysses import sp_seq_len

    b, tokens, _ = SP_SHAPE
    d = HEAD_DIM
    l = sp_seq_len(tokens, sp, "ring")
    shard = l // shards
    name = f"s_ring_B{b}_L{shard}x{shards}_N{n}"
    q, k, v = (torch.randn(b, l, n, d, generator=gen, device=DEVICE,
                           dtype=torch.bfloat16) for _ in range(3))
    cut = [[c.contiguous() for c in x.split(shard, dim=1)]
           for x in (q, k, v)]
    real = torch.full((b,), tokens, dtype=torch.int32, device=DEVICE)
    path = torch.cat(run_ranks(lambda c: ring.ring_self_attention(
        *(x[c.rank] for x in cut), real, c), thread_mesh(seq=shards)),
        dim=1)[:, :tokens]
    one = fa.flash_attention_cuda(*(x[:, :tokens].contiguous()
                                    for x in (q, k, v)))
    one_pass = dict(max_abs=float((path.float() - one.float()).abs().max()),
                    differing=int((path != one).sum()),
                    elements=path.numel(), bit_equal=torch.equal(path, one))
    path_err = _check(name, "the ring's path vs one card's kernel", path,
                      one, FLASH_REL_TOL)
    if not one_pass["bit_equal"]:
        raise RuntimeError(f"{name}: the ring's path is not one card's "
                           f"kernel bit for bit: {one_pass}")
    del path, one

    def ring_out(k_lens, check=False):
        outs, errs = [], []
        for i in range(shards):
            state = plain = None
            for step in range(shards):
                j = step  # natural order, as the ring walks the shards
                last = step == shards - 1
                args = (cut[0][i], cut[1][j], cut[2][j],
                        ring._local_klens(k_lens, j, shard))
                held = [x[1].clone() for x in state[:3]] \
                    if check and state is not None and j == shards - 1 \
                    else None
                state = fa.flash_attention_carry_cuda(*args, state, last)
                if not check:
                    continue
                plain = fa.flash_attention_carry_plain(*args, plain, last)
                pair = f"{name} pair ({i}, {j})"
                errs += _check_carry(pair, state, plain)
                if held is not None and not all(
                        torch.equal(state[w][1], held[w])
                        for w in ((1, 2) if last else (0, 1, 2))):
                    raise RuntimeError(f"{pair}: the empty key shard's "
                                       "step changed the state")
            outs.append(state[0])
        return torch.cat(outs, dim=1), errs

    errs = []
    got, _ = ring_out(None)
    errs.append(_check(name, "ring vs one-shot kernel", got,
                       fa.flash_attention_cuda(q, k, v), FLASH_REL_TOL))
    k_lens = torch.tensor([tokens, (shards - 1) * shard], dtype=torch.int32,
                          device=DEVICE)
    if int(ring._local_klens(k_lens, shards - 1, shard)[1]) != 0:
        raise RuntimeError(f"{name}: batch entry 1's last key shard is not "
                           "empty")
    got, pair_errs = ring_out(k_lens, check=True)
    errs.append(_check(name, "ring with an empty shard vs plain", got,
                       fa.flash_attention_plain(q, k, v, k_lens),
                       FLASH_REL_TOL))
    errs += pair_errs
    q0, k0, v0 = cut[0][0], cut[1][1], cut[2][1]
    state = fa.flash_attention_carry_cuda(q0, cut[1][0], cut[2][0],
                                          last=False)
    plain = fa.CarryState(*(x.clone() for x in state[:3]))
    spare = _spare_grid(name, q0, k0, v0, state,
                        fa.flash_attention_carry_cuda(
                            q0, k0, v0, None,
                            fa.CarryState(*(x.clone() for x in state)),
                            False))
    part = fa.flash_attention_with_stats(q0, k0, v0)
    acc = ring.ring_merge(part[0].float(), part[1], part[2], *part)
    qt, kt, vt = (x.transpose(1, 2) for x in (q0, k0, v0))
    bound_ms, bound_by = carry_bound(b, shard, shard, n)
    row = dict(
        case=name, kernel="carry", B=b, Lq=shard, Lk=shard, N=n,
        shards=shards, max_abs_err=max(e[0] for e in errs + [path_err]),
        rel_err=max(e[1] for e in errs + [path_err]),
        ring_rel_err=errs[0][1], empty_shard_rel_err=errs[1][1],
        path_vs_one_card=one_pass,
        ms=cuda_ms(lambda: fa.flash_attention_carry_cuda(
            q0, k0, v0, None, state, False)),
        plain_ms=cuda_ms(lambda: fa.flash_attention_carry_plain(
            q0, k0, v0, None, plain, False), iters=5, warmup=1),
        library_ms=cuda_ms(lambda: torch.nn.functional
                           .scaled_dot_product_attention(qt, kt, vt)),
        bound_ms=bound_ms, bound_by=bound_by,
        stats_ms=cuda_ms(lambda: fa.flash_attention_stats_cuda(q0, k0, v0)),
        merge_ms=cuda_ms(lambda: ring.ring_merge(*acc, *part)),
        before_redesign_ms=None, **spare)
    del q, k, v, cut, got, state, plain, part, acc
    torch.cuda.empty_cache()
    return row


def phase_sp_ring_pieces(report):
    """(b) The kernels at the shapes the SP modes of 13a launch, each
    against its plain twin on the same inputs (``_sp_kernel_shapes``):
    the forward kernel over Ulysses' N/sp heads and all 7,800 tokens and
    on the cross-attention's query shards; the ring of carried launches
    for each ring group of ring and USP (and at 4 key shards), dense
    against the one-shot kernel and with an empty key shard against the
    plain twin, step by step (``_sp_ring_case``). Launches here are
    comparisons, not the path's."""
    import torch

    b, l, n = SP_SHAPE
    heads, rings, rows = _sp_kernel_shapes()
    gen = torch.Generator(device=DEVICE).manual_seed(14)
    fwd, carry = [], []
    with torch.no_grad():
        for nu in heads:
            q, k, v = (torch.randn(b, l, nu, HEAD_DIM, generator=gen,
                                   device=DEVICE, dtype=torch.bfloat16)
                       for _ in range(3))
            fwd.append(_sp_fwd_case(f"u_self_B{b}_L{l}_N{nu}", q, k, v))
            log("phase 13b: " + json.dumps(fwd[-1]))
        for lq in rows:
            q = torch.randn(b, lq, n, HEAD_DIM, generator=gen, device=DEVICE,
                            dtype=torch.bfloat16)
            k, v = (torch.randn(b, 512, n, HEAD_DIM, generator=gen,
                                device=DEVICE, dtype=torch.bfloat16)
                    for _ in range(2))
            fwd.append(_sp_fwd_case(f"x_cross_B{b}_Lq{lq}_Lk512", q, k, v))
            log("phase 13b: " + json.dumps(fwd[-1]))
        del q, k, v
        for nr, shards, sp in rings:
            carry.append(_sp_ring_case(nr, shards, sp, gen))
            log("phase 13b: " + json.dumps(carry[-1]))
    report["sp_kernels"] = dict(fwd=fwd, carry=carry)
    torch.cuda.empty_cache()


def phase_sp_fsdp(report):
    """(c) The FSDP variant under thread ranks at sp = 2: the t2v-14B DiT
    at full width (``SP_FSDP_LAYERS`` blocks), bf16 and W8A8, its block
    weights as shards gathered per block, against the unsharded Ulysses
    forward; umT5-XXL at full width (``SP_FSDP_T5_LAYERS`` layers) with
    its gathers against the unsharded encoder. Equal bit for bit: the
    gathered weights are the same bytes."""
    import torch

    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.models.t5 import T5Encoder
    from moviigen_tpu_torch.models.wan_model import WanModel
    from moviigen_tpu_torch.ops import flash_attention as fa
    from moviigen_tpu_torch.ops import int8_gemm as ig
    from moviigen_tpu_torch.parallel import sharding
    from moviigen_tpu_torch.parallel.comm import run_ranks, thread_mesh
    from moviigen_tpu_torch.parallel.ulysses import sequence_parallel_forward

    config = WAN_CONFIGS["t2v-14B"]
    cfg = config.model.replace(num_layers=SP_FSDP_LAYERS)
    rows = {}
    with torch.no_grad():
        for quant in (None, "w8a8"):
            gen = torch.Generator(device=DEVICE).manual_seed(15)
            model = WanModel(cfg, dtype=torch.bfloat16, device=DEVICE,
                             quant=quant).init_weights(gen)
            model.head.weight.normal_(0.0, 0.02, generator=gen)
            x, t, ctx, rope = _dit_inputs(cfg, gen)
            out = {}
            for fsdp in (False, True):
                def fwd(comm):
                    m = model
                    if fsdp:
                        m = sharding.shard_params(
                            model, sharding.dit_param_specs(model), comm,
                            "seq")
                    return sequence_parallel_forward(
                        m, x, t, ctx, rope, comm, seq_len=7800,
                        fsdp_params=fsdp)

                fa.reset_launch_counts()
                ig.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out[fsdp] = run_ranks(fwd, thread_mesh(seq=2))
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                counts = {**fa.launch_counts(), **ig.launch_counts()}
            tag = quant or "bf16"
            w8a8 = quant == "w8a8"
            expected = dict.fromkeys(counts, 0)
            expected.update(
                launches=2 * 2 * SP_FSDP_LAYERS,
                int8_gemm_launches=2 * 10 * SP_FSDP_LAYERS * w8a8,
                quantize_launches=2 * 7 * SP_FSDP_LAYERS * w8a8)
            equal = all(torch.equal(o, out[False][0])
                        for o in out[True] + out[False])
            rows[tag] = dict(equal=equal, fsdp_s=secs, launches=counts,
                             pred_norm=float(out[False][0].float().norm()))
            log(f"phase 13c: dit {tag} " + json.dumps(rows[tag]))
            if not equal:
                raise RuntimeError(f"fsdp {tag}: the sharded forward is not "
                                   "the unsharded one")
            if counts != expected:
                raise RuntimeError(f"fsdp {tag}: launches {counts}, "
                                   f"expected {expected}")
            del model, out
            torch.cuda.empty_cache()
        gen = torch.Generator(device=DEVICE).manual_seed(16)
        t5 = T5Encoder(config.t5.replace(num_layers=SP_FSDP_T5_LAYERS),
                       dtype=torch.bfloat16, device=DEVICE)
        t5.init_weights(gen)
        ids = torch.randint(0, config.t5.vocab_size, (2, 512),
                            generator=gen, device=DEVICE)
        mask = torch.ones_like(ids)
        mask[1, 40:] = 0
        want = t5(ids, mask)

        def enc(comm):
            m = sharding.shard_params(t5, sharding.t5_param_specs(t5), comm,
                                      "seq")
            return m(ids, mask,
                     param_gather_fn=sharding.make_param_gather(comm, "seq"))

        outs = run_ranks(enc, thread_mesh(seq=2))
        equal = all(torch.equal(o, want) for o in outs)
        rows["t5"] = dict(equal=equal, layers=SP_FSDP_T5_LAYERS)
        log("phase 13c: t5 " + json.dumps(rows["t5"]))
        if not equal:
            raise RuntimeError("fsdp t5: the gathered encoder is not the "
                               "unsharded one")
        del t5, outs, want
    report["sp_fsdp"] = rows
    torch.cuda.empty_cache()


def phase_sp_cli(report):
    """(d) ``cli.generate`` in this process under torchrun's variables for
    one rank: NCCL at world size 1, over 8b's random ``CKPT_TASK``
    directory, without and then with ``--dit_fsdp --t5_fsdp`` (a (1, 1)
    mesh: both models as shards, gathered per block, the DiT through the
    SP forward); the two videos equal. The CLI's own log (the mesh, the
    request's timings) is shown at INFO. The process group is taken down
    after."""
    import logging
    import socket

    import torch
    import torch.distributed as dist

    from moviigen_tpu_torch.cli import generate
    from moviigen_tpu_torch.ops import flash_attention as fa
    from moviigen_tpu_torch.parallel import distributed

    ckpt = _ckpt_dir(report, "13d")
    root = ckpt.parent
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               LOCAL_WORLD_SIZE="1", MASTER_ADDR="localhost",
               MASTER_PORT=str(port))
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    videos = []
    keep = generate.cache_video

    def capture(video, save_file, **kwargs):
        videos.append(video)
        return keep(video, save_file=save_file, **kwargs)

    generate.cache_video = capture
    rows = []
    level = logging.getLogger().level
    logging.getLogger().setLevel(logging.INFO)
    try:
        t0 = time.perf_counter()
        if not distributed.maybe_initialize_distributed(strict=True):
            raise RuntimeError("cli: torch.distributed did not start")
        init_s = time.perf_counter() - t0
        world, backend = dist.get_world_size(), dist.get_backend()
        log(f"phase 13d: process group up in {init_s:.2f} s: {backend}, "
            f"world size {world}")
        argv = ["--task", CKPT_TASK, "--device", DEVICE, "--size",
                "832*480", "--frame_num", "5", "--sample_steps", "2",
                "--base_seed", "42", "--prompt", PROMPT, "--ckpt_dir",
                str(ckpt)]
        for flags in ([], ["--dit_fsdp", "--t5_fsdp"]):
            fa.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = generate.main(argv + flags + [
                "--save_file", str(root / f"sp_cli{len(flags)}.mp4")])
            torch.cuda.synchronize()
            rows.append(dict(flags=flags, total_s=time.perf_counter() - t0,
                             launches=fa.launch_counts(), saved=out))
            log("phase 13d: " + json.dumps(rows[-1]))
            if out is None or not os.path.getsize(out):
                raise RuntimeError(f"cli {flags}: no video written")
            # 2 steps x 1 batched forward x 2 attention sites x the blocks
            if rows[-1]["launches"]["launches"] != 2 * 2 * CKPT_DIT_LAYERS:
                raise RuntimeError(f"cli {flags}: launches "
                                   f"{rows[-1]['launches']}")
    finally:
        logging.getLogger().setLevel(level)
        generate.cache_video = keep
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    equal = bool(np.array_equal(videos[0], videos[1]))
    _serve_checks("sp cli", videos[0], 5)
    report["sp_cli"] = dict(backend=backend, world_size=world,
                            init_s=init_s, equal=equal, runs=rows)
    log("phase 13d: " + json.dumps(dict(backend=backend, world_size=world,
                                        init_s=init_s, equal=equal)))
    if backend != "nccl" or world != 1:
        raise RuntimeError(f"cli: {backend} at world size {world}, not NCCL "
                           "at 1")
    if not equal:
        raise RuntimeError("cli: --dit_fsdp --t5_fsdp changed the video")
    _release_ckpt_dir(report, 13)
    torch.cuda.empty_cache()


def phase_sp(report):
    t0 = time.perf_counter()
    for sub in (phase_sp_forward, phase_sp_ring_pieces, phase_sp_fsdp,
                phase_sp_cli):
        sub(report)
    log(f"phase 13: {time.perf_counter() - t0:.1f} s")

# --------------------------------------- host utilities and the apps

# Phase 14b: umT5-XXL's decoder at full width with its depth cut to 2
# layers; 2 decoder sequences of 64 tokens over the encoder's 512, both
# masks live. fp32 on the card (TF32 off) against the CPU: the sums run in
# another order, so within 1e-4 of the output's largest value.
T5_DEC_LAYERS, T5_DEC_LEN = 2, 64
T5_DEC_REL_TOL = 1e-4
# Phase 14c: the gradio app's Generate over 8b's directory, r1's shape.
APP_FRAMES, APP_STEPS, APP_SEEDS = 17, 4, (42, 43)


@contextlib.contextmanager
def captured_logs():
    """The root logger's (level, message) pairs while inside, at INFO."""
    import logging

    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s] %(levelname)s: %(message)s")
    lines = []

    class Lines(logging.Handler):
        def emit(self, record):
            lines.append((record.levelno, record.getMessage()))

    root = logging.getLogger()
    handler, level = Lines(logging.INFO), root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    try:
        yield lines
    finally:
        root.removeHandler(handler)
        root.setLevel(level)


def _ckpt_dir(report, phase):
    """8b's random ``CKPT_TASK`` directory, exported here when phase 8 did
    not run; ``_release_ckpt_dir`` deletes it after its last user."""
    if report.get("ckpt_dir_path") is None:
        root = pathlib.Path(__file__).resolve().parent / "_smoke_out" / "serve"
        report["ckpt_dir_path"] = _export_ckpt_dir(root, phase)[0]
    _cut_task()
    return report["ckpt_dir_path"]


def _release_ckpt_dir(report, phase):
    import shutil

    keepers = report.setdefault("ckpt_keepers", set())
    keepers.discard(phase)
    if not keepers and report.get("ckpt_dir_path") is not None:
        shutil.rmtree(report.pop("ckpt_dir_path").parent, ignore_errors=True)


def traced_flash_launches(kernels):
    """Launches of the port's flash kernels in a trace's ``{kernel:
    (launches, ms)}``: the stats forward, the forward, the ring's carried
    forward, dKV (its chunk-sum kernel apart) and dQ."""
    out = dict(stats=0, fwd=0, carry=0, dkv=0, dq=0)
    for name, (count, _) in kernels.items():
        cat = _kernel_category(name)
        if cat.startswith("flash forward stats"):
            out["stats"] += count
        elif cat.startswith("flash forward carried"):
            out["carry"] += count
        elif cat.startswith("flash forward"):
            out["fwd"] += count
        elif cat.startswith("flash dKV") and "reduce" not in name:
            out["dkv"] += count
        elif cat.startswith("flash dQ"):
            out["dq"] += count
    return out


def phase_ft_profiled(report):
    """(a) ``cli.finetune`` for t2v-1.3B as phase 6b runs it (full width
    and depth, 32,760 tokens, per-block remat, 6b's synthetic dataset; a
    random model with a live head) with ``--profile_steps 2``: the loader
    reads every batch through the native pool (its counter), the Chrome
    trace under ``<output_dir>/profile`` holds 2 steps' stats, dKV and dQ
    launches (6b's per-step counts), the timer's line is logged; then 6b's
    dataset through ``DataLoader`` with and without the pool, bit-equal."""
    import shutil

    import torch

    from moviigen_tpu_torch.cli import finetune
    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.ops import flash_attention as fa
    from moviigen_tpu_torch.training.data import (
        DataLoader, LatentDataset,
        SPAwareAspectRatioLengthBucketDistributedSampler)

    root = pathlib.Path(__file__).resolve().parent / "_smoke_out" / "utils"
    shutil.rmtree(root, ignore_errors=True)
    cfg = WAN_CONFIGS[TRAIN_TASK].model
    data_json = _latent_dataset(root / "data", TRAIN_LATENT,
                                len(PROMPT_LENS), cfg.text_dim, 0)
    out_dir = root / "out"
    fa.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with live_head(), captured_logs() as lines:
        record = finetune.main([
            "--task", TRAIN_TASK, "--device", DEVICE,
            "--data_json_path", str(data_json), "--num_latent_t", "21",
            "--gradient_checkpointing", "--max_train_steps", str(TRAIN_STEPS),
            "--profile_steps", "2", "--checkpointing_steps", "1000",
            "--output_dir", str(out_dir), "--seed", "0"])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    counts = fa.launch_counts()
    report["ft_profile_launches"] = counts
    sites = 2 * cfg.num_layers  # self + cross attention per block
    per_step = dict(stats=2 * sites, fwd=0, carry=0, dkv=sites, dq=sites)
    want = dict(dict.fromkeys(fa.COUNTERS, 0),
                stats_launches=per_step["stats"] * TRAIN_STEPS,
                dkv_launches=sites * TRAIN_STEPS,
                dq_launches=sites * TRAIN_STEPS)
    tr = record["profile"]
    traced = traced_flash_launches(tr.kernels)
    want_traced = {k: 2 * v for k, v in per_step.items()}
    timer = [m for _, m in lines
             if "profiler trace written" in m and "phases: step=" in m]
    pool = [m for _, m in lines if m == "native reader pool in use"]
    trace_mb = os.path.getsize(tr.path) / 2**20
    log(f"phase 14a: finetune {TRAIN_STEPS} steps, 2 profiled, in "
        f"{main_s:.1f} s: loss {record['loss']}, step_s {record['step_s']}, "
        f"launches {counts}; trace {tr.path} ({trace_mb:.1f} MiB), traced "
        f"flash launches {traced}; batches through the pool "
        f"{record['native_batches']}, in Python {record['python_batches']}; "
        f"timer line {timer}")
    if record["step"] != TRAIN_STEPS or not np.isfinite(record["loss"]).all():
        raise RuntimeError(f"ft profiled: step {record['step']}, loss "
                           f"{record['loss']}")
    if counts != want:
        raise RuntimeError(f"ft profiled: launches {counts}, expected {want}")
    if traced != want_traced:
        raise RuntimeError(f"ft profiled: the trace holds {traced}, 2 steps "
                           f"launch {want_traced}")
    if pathlib.Path(tr.path).parent != out_dir / "profile":
        raise RuntimeError(f"ft profiled: trace written to {tr.path}")
    if len(timer) != 1:
        raise RuntimeError("ft profiled: the timer's line was not logged")
    if (record["python_batches"] or record["native_batches"] < TRAIN_STEPS
            or not pool):
        raise RuntimeError("ft profiled: the loader did not read every batch "
                           "through the native pool")
    summary = kernel_summary(tr.kernels, "14a", trace_mb=trace_mb,
                             shape="t2v-1.3B fine-tune, 2 steps, 32,760 "
                                   "tokens, per-block remat")

    # 6b's dataset through the loader with the pool and without it, in
    # turns; the files are in the page cache (just written)
    ds = LatentDataset(str(data_json), 21, txt_max_len=cfg.text_len,
                       text_dim=cfg.text_dim, seed=0)
    sampler = SPAwareAspectRatioLengthBucketDistributedSampler(
        batch_size=1, dataset_size=len(ds), rank=0, world_size=1, sp_size=1,
        lengths=ds.lengths, aspect_ratios=list(ds.aspect_ratios), seed=0)
    batches, ms = {}, {True: [], False: []}
    for native in (False, True, True, False):
        dl = DataLoader(ds, sampler, batch_size=1, prefetch=0,
                        use_native=native)
        t0 = time.perf_counter()
        got = list(dl)
        ms[native].append((time.perf_counter() - t0) * 1e3 / len(got))
        if dl.uses_native != native or (dl.native_batches if native
                                        else dl.python_batches) != len(got):
            raise RuntimeError(f"loader use_native={native}: "
                               f"{dl.native_batches} native, "
                               f"{dl.python_batches} Python batches")
        dl.close()
        batches.setdefault(native, got)
    equal = len(batches[True]) == len(batches[False]) == len(PROMPT_LENS) \
        and all(a.dtype == b.dtype and np.array_equal(a, b)
                for bt, bf in zip(batches[True], batches[False])
                for a, b in zip(bt, bf))
    row = dict(main_s=main_s, step_s=record["step_s"], launches=counts,
               traced=traced, trace_mb=trace_mb, timer=timer[0],
               native_batches=record["native_batches"],
               loader_ms_per_batch={"pool": ms[True], "python": ms[False]},
               loader_equal=equal,
               device_ms_by_category=summary["categories_ms"])
    log("phase 14a: " + json.dumps(row))
    report["ft_profiled"] = row
    if not equal:
        raise RuntimeError("loader: batches through the pool differ")
    del record, batches
    shutil.rmtree(root)
    torch.cuda.empty_cache()


def phase_t5_decoder(report):
    """(b) The umT5-XXL decoder at full width (2 layers, random weights)
    in fp32 on the card against the same weights on the CPU, then in bf16
    on the card."""
    import torch

    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.models import t5

    cfg = WAN_CONFIGS["t2v-14B"].t5.replace(num_layers=T5_DEC_LAYERS)
    gen = torch.Generator(device=DEVICE).manual_seed(14)
    model = t5.T5Decoder(cfg, dtype=torch.float32, device=DEVICE)
    model.init_weights(gen)
    sd = t5.t5_decoder_state_dict(model)
    cpu = t5.load_t5_decoder_state_dict(
        t5.T5Decoder(cfg, dtype=torch.float32), sd)
    rng = np.random.default_rng(14)
    ids = rng.integers(0, cfg.vocab_size, (2, T5_DEC_LEN))
    ids[0, -1] = cfg.vocab_size + 7  # clipped to the last entry
    enc = rng.standard_normal((2, 512, cfg.dim), dtype=np.float32)
    enc_mask = np.ones((2, 512), np.int64)
    enc_mask[1, 77:] = 0
    mask = np.ones((2, T5_DEC_LEN), np.int64)
    mask[0, 40:] = 0
    cpu_in = [torch.from_numpy(a) for a in (ids, enc, enc_mask, mask)]
    dev_in = [a.to(DEVICE) for a in cpu_in]
    with torch.no_grad():
        got = model(*dev_in)
        ms = cuda_ms(lambda: model(*dev_in), iters=5, warmup=1)
        t0 = time.perf_counter()
        want = cpu(*cpu_in)
        cpu_s = time.perf_counter() - t0
        err = float((got.cpu() - want).abs().max() / want.abs().max())
        model16 = t5.load_t5_decoder_state_dict(
            t5.T5Decoder(cfg, dtype=torch.bfloat16, device=DEVICE), sd)
        got16 = model16(*dev_in)
        ms16 = cuda_ms(lambda: model16(*dev_in), iters=5, warmup=1)
        err16 = float((got16.float() - got).abs().max() / got.abs().max())
    row = dict(layers=T5_DEC_LAYERS, dim=cfg.dim, heads=cfg.num_heads,
               ffn=cfg.dim_ffn, decoder_tokens=T5_DEC_LEN,
               encoder_tokens=512, fp32_ms=ms, cpu_s=cpu_s,
               fp32_rel_err=err, tol=T5_DEC_REL_TOL, bf16_ms=ms16,
               bf16_rel_err=err16)
    log("phase 14b: t5 decoder " + json.dumps(row))
    report["t5_decoder"] = row
    if tuple(got.shape) != (2, T5_DEC_LEN, cfg.dim):
        raise RuntimeError(f"t5 decoder: output shape {tuple(got.shape)}")
    if not (bool(torch.isfinite(got).all())
            and bool(torch.isfinite(got16).all())):
        raise RuntimeError("t5 decoder: non-finite output")
    if not err <= T5_DEC_REL_TOL:
        raise RuntimeError(f"t5 decoder: card vs CPU {err:.3e} > "
                           f"{T5_DEC_REL_TOL}")
    del model, model16, cpu, sd
    torch.cuda.empty_cache()


def _gradio_stub(registry):
    """A ``gradio`` whose components do nothing and whose buttons record
    their callbacks in ``registry`` (gradio is an optional dependency)."""
    import types

    class Component:
        def __init__(self, *args, **kwargs):
            self.label = kwargs.get("label")

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    class Button(Component):
        def click(self, fn, inputs=None, outputs=None):
            registry.append(dict(fn=fn, inputs=inputs, outputs=outputs))

    gr = types.ModuleType("gradio")
    for name in ("Blocks", "Row", "Column", "Textbox", "Radio", "Dropdown",
                 "Slider", "Number", "Video", "Markdown"):
        setattr(gr, name, Component)
    gr.Button = Button
    return gr


def _hub_offline():
    """Refuse to go on unless the Hugging Face hub is offline (main sets
    HF_HUB_OFFLINE before anything imports it): the rewriter must not try
    to download."""
    try:
        from huggingface_hub import constants
    except ImportError:
        return
    if not constants.HF_HUB_OFFLINE:
        raise RuntimeError("the Hugging Face hub is not offline")


def phase_app(report):
    """(c) The gradio app (``apps/gradio_t2v.build_app``, gradio stubbed)
    over 8b's directory: its Generate callback answers two requests
    (832*480, 17 frames, 4 steps, two seeds), each video equal to
    ``WanT2V.generate``'s with the same arguments; Prompt Enhance with the
    local rewriter and no weights gives the prompt back."""
    import types

    import torch

    from moviigen_tpu_torch.apps import gradio_t2v
    from moviigen_tpu_torch.ops import flash_attention as fa
    from moviigen_tpu_torch.pipelines.text2video import WanT2V

    ckpt = _ckpt_dir(report, "14c")
    _hub_offline()
    registry, videos = [], []
    keep_gradio = sys.modules.get("gradio")
    keep_cache = gradio_t2v.cache_video

    def capture(video, save_file=None, **kwargs):
        videos.append(video)
        return keep_cache(video, save_file=save_file, **kwargs)

    app_dir = ckpt.parent / "app"  # the app writes example.mp4 to the cwd
    app_dir.mkdir(exist_ok=True)
    cwd = os.getcwd()
    sys.modules["gradio"] = _gradio_stub(registry)
    gradio_t2v.cache_video = capture
    os.chdir(app_dir)
    rows = []
    try:
        args = types.SimpleNamespace(
            task=CKPT_TASK, ckpt_dir=str(ckpt), frame_num=APP_FRAMES,
            device=DEVICE, prompt_extend_method="local_qwen",
            prompt_extend_model=None)
        t0 = time.perf_counter()
        gradio_t2v.build_app(args)
        init_s = time.perf_counter() - t0
        enhance, generate = registry
        if len(generate["inputs"]) != 7 or len(enhance["inputs"]) != 2:
            raise RuntimeError(f"app: buttons wired with "
                               f"{len(enhance['inputs'])} and "
                               f"{len(generate['inputs'])} inputs")
        for seed in APP_SEEDS:
            fa.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = generate["fn"](PROMPT, "832*480", APP_STEPS, 5.0, 5.0,
                                  seed, "")
            torch.cuda.synchronize()
            rows.append(dict(seed=seed, request_s=time.perf_counter() - t0,
                             launches=fa.launch_counts(), path=path))
            log("phase 14c: app request " + json.dumps(rows[-1]))
            if not os.path.getsize(path):
                raise RuntimeError("app: no video written")
            # r1's shape batches the CFG pair: one forward a step, 2 sites
            if rows[-1]["launches"]["launches"] != (APP_STEPS * 2
                                                    * CKPT_DIT_LAYERS):
                raise RuntimeError(f"app: launches {rows[-1]['launches']}")
        t0 = time.perf_counter()
        enhanced = enhance["fn"](PROMPT, "en")
        enhance_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        gradio_t2v.cache_video = keep_cache
        if keep_gradio is None:
            sys.modules.pop("gradio", None)
        else:
            sys.modules["gradio"] = keep_gradio
    report["app_launches"] = {
        k: sum(r["launches"][k] for r in rows) for k in fa.COUNTERS}
    ref = WanT2V(_cut_task(), device=DEVICE, checkpoint_dir=str(ckpt))
    equal = []
    for seed, video in zip(APP_SEEDS, videos):
        _serve_checks("app", video, APP_FRAMES)
        want = ref.generate(PROMPT, size=(832, 480), frame_num=APP_FRAMES,
                            shift=5.0, sampling_steps=APP_STEPS,
                            guide_scale=5.0, n_prompt="", seed=seed)
        equal.append(bool(np.array_equal(video, want)))
    row = dict(init_s=init_s, requests=rows, equal=equal,
               seeds_differ=not np.array_equal(videos[0], videos[1]),
               enhance_s=enhance_s, enhance_kept_prompt=enhanced == PROMPT)
    log("phase 14c: " + json.dumps(row))
    report["app"] = row
    if not all(equal) or len(equal) != len(APP_SEEDS):
        raise RuntimeError(f"app: videos equal to WanT2V.generate: {equal}")
    if not row["seeds_differ"]:
        raise RuntimeError("app: two seeds gave one video")
    if enhanced != PROMPT:
        raise RuntimeError(f"app: Prompt Enhance gave {enhanced!r}")
    del ref
    torch.cuda.empty_cache()


def phase_cli_prompt_extend(report):
    """(d) ``cli.generate --use_prompt_extend`` over 8b's directory with
    each rewriter failing (``local_qwen`` offline with no weights,
    ``dashscope`` with no SDK): a warning, and the video of the run
    without the flag (PSNR inf); the latents compared by
    ``latent_parity_report``."""
    import logging

    import torch

    from moviigen_tpu_torch.cli import generate
    from moviigen_tpu_torch.ops import flash_attention as fa
    from moviigen_tpu_torch.pipelines.text2video import WanT2V
    from moviigen_tpu_torch.utils.metrics import latent_parity_report, psnr

    ckpt = _ckpt_dir(report, "14d")
    _hub_offline()
    videos, latents = [], []
    keep_cache, keep_decode = generate.cache_video, WanT2V.decode_request
    keep_sdk = sys.modules.get("dashscope")

    def capture(video, save_file=None, **kwargs):
        videos.append(video)
        return keep_cache(video, save_file=save_file, **kwargs)

    def decode(self, latent):
        latents.append(latent[0].float().cpu().numpy())
        return keep_decode(self, latent)

    argv = ["--task", CKPT_TASK, "--device", DEVICE, "--size", "832*480",
            "--frame_num", "5", "--sample_steps", "2", "--base_seed", "42",
            "--prompt", PROMPT, "--ckpt_dir", str(ckpt)]
    runs = [("none", []),
            ("local_qwen", ["--use_prompt_extend", "--prompt_extend_method",
                            "local_qwen"]),
            ("dashscope", ["--use_prompt_extend", "--prompt_extend_method",
                           "dashscope", "--prompt_extend_target_lang", "en"])]
    rows = []
    generate.cache_video, WanT2V.decode_request = capture, decode
    sys.modules["dashscope"] = None  # no SDK: and so no request leaves
    try:
        for name, flags in runs:
            fa.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with captured_logs() as lines:
                out = generate.main(argv + flags + [
                    "--save_file", str(ckpt.parent / f"extend_{name}.mp4")])
            torch.cuda.synchronize()
            warned = [m for lvl, m in lines if lvl == logging.WARNING
                      and m.startswith("prompt extension failed")]
            rows.append(dict(method=name, total_s=time.perf_counter() - t0,
                             launches=fa.launch_counts(), warned=warned,
                             prompt_kept=f"prompt: {PROMPT}" in
                             [m for _, m in lines]))
            log("phase 14d: " + json.dumps(rows[-1]))
            if out is None or not os.path.getsize(out):
                raise RuntimeError(f"cli {name}: no video written")
            if len(warned) != (1 if flags else 0) or not rows[-1][
                    "prompt_kept"]:
                raise RuntimeError(f"cli {name}: warnings {warned}")
            if rows[-1]["launches"]["launches"] != 2 * 2 * CKPT_DIT_LAYERS:
                raise RuntimeError(f"cli {name}: launches "
                                   f"{rows[-1]['launches']}")
    finally:
        generate.cache_video, WanT2V.decode_request = keep_cache, keep_decode
        if keep_sdk is None:
            sys.modules.pop("dashscope", None)
        else:
            sys.modules["dashscope"] = keep_sdk
    report["extend_launches"] = {
        k: sum(r["launches"][k] for r in rows[1:]) for k in fa.COUNTERS}
    _serve_checks("cli extend", videos[0], 5)
    psnrs = [psnr(v, videos[0]) for v in videos[1:]]
    parity = [latent_parity_report(lat, latents[0]) for lat in latents[1:]]
    row = dict(runs=rows, psnr_db=psnrs, latent_parity=parity)
    log("phase 14d: " + json.dumps(row))
    report["cli_extend"] = row
    if len(videos) != 3 or not all(p == float("inf") for p in psnrs):
        raise RuntimeError(f"cli: the rewriter's failure changed the video "
                           f"(PSNR {psnrs})")


def phase_utils(report):
    """Phase 14: the host utilities and the apps on the card."""
    import gc

    t0 = time.perf_counter()
    for sub in (phase_ft_profiled, phase_t5_decoder, phase_app,
                phase_cli_prompt_extend):
        sub(report)
        gc.collect()
    _release_ckpt_dir(report, 14)
    log(f"phase 14: {time.perf_counter() - t0:.1f} s")


def phase_qlora_profile(report):
    """Phase 11a's QLoRA run (``cli.finetune --task t2v-14B --use_lora
    --quant int8 --gradient_checkpointing``, 32,760 tokens) with
    ``--profile_steps 2``: device ms by category and the top 40 kernels of
    its first two steps. Not in the default phases."""
    import shutil

    import torch

    from moviigen_tpu_torch.cli import finetune
    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.ops import flash_attention as fa

    root = pathlib.Path(__file__).resolve().parent / "_smoke_out" / "lora"
    shutil.rmtree(root, ignore_errors=True)
    cfg = WAN_CONFIGS[LORA_TASK].model
    data_json = _latent_dataset(root / "data", TRAIN_LATENT, 2,
                                cfg.text_dim, 0)
    fa.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with live_head():
        record = finetune.main([
            "--task", LORA_TASK, "--device", DEVICE, "--use_lora",
            "--quant", "int8", "--gradient_checkpointing",
            "--lora_rank", str(LORA_RANK), "--lora_alpha", str(LORA_ALPHA),
            "--learning_rate", str(LORA_LR),
            "--data_json_path", str(data_json), "--num_latent_t", "21",
            "--max_train_steps", str(LORA_STEPS), "--profile_steps", "2",
            "--checkpointing_steps", "1000", "--output_dir",
            str(root / "out"), "--seed", "0"])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    report["qlora_profile_launches"] = counts = fa.launch_counts()
    tr = record["profile"]
    traced = traced_flash_launches(tr.kernels)
    sites = 2 * cfg.num_layers
    want = dict(stats=4 * sites, fwd=0, carry=0, dkv=2 * sites,
                dq=2 * sites)
    log(f"phase 15: QLoRA {LORA_TASK} int8, {LORA_STEPS} steps, 2 "
        f"profiled, in {main_s:.1f} s: step_s {record['step_s']}, launches "
        f"{counts}, traced {traced}")
    report["qlora_profile"] = kernel_summary(
        tr.kernels, 15, shape="t2v-14B QLoRA int8, 2 steps, 32,760 tokens, "
        "per-block remat", step_s=record["step_s"],
        trace_mb=os.path.getsize(tr.path) / 2**20)
    if traced != want:
        raise RuntimeError(f"qlora profiled: the trace holds {traced}, 2 "
                           f"steps launch {want}")
    del record
    shutil.rmtree(root)
    torch.cuda.empty_cache()



# --------------------------------------- sequence-parallel training

# Phase 16: training under sequence parallelism on the one card, the
# mesh's ranks as threads of this process (NCCL puts no two ranks on one
# GPU). 16a: the ring's pair kernels at the ft shape cut in two (32,760
# tokens, sp 2), at the 1.3B's 12 heads and the 14B's 40; B = 2 with batch
# entry 1's keys ending at the cut, so its second key shard is empty.
SPT_TOKENS, SPT_SHARDS = 32760, 2
SPT_PAIR_HEADS = (TRAIN_HEADS, HEADS)
# 16b, cell st1: one t2v-1.3B train step at full width and depth and
# 32,760 tokens (ft's shape), per-block remat, the block weights as shards
# gathered per block; (name, sp_mode, data, ring, seq).
SPT_CASES = [
    ("ulysses_sp2", "ulysses", 1, 1, 2),
    ("ring_sp2", "ring", 1, 1, 2),
    ("usp_r2_u2", "usp", 1, 2, 2),
]
# Every gradient of the SP step against the one-process step's,
# norm-relative: both bf16 compute; Ulysses' attention is the same work
# items as the one process's, the ring walks the keys in another order (P
# rounded against another running max) and runs its backward per pair,
# each rank's dK of the cross-attention covers its own queries and is
# rounded to bf16 before the ranks' sum, and the gradients' sums over
# ranks run in other orders. §2's gradient gate (GRAD_REL_TOL) bounds
# that; a gradient scaled by the world size, or one shard's missing, is
# off by O(1). A linear's weight and bias are held as one tensor (the bias
# is the weight of a constant input): the key biases' gradients alone are
# near-cancellations (the softmax does not change when every key moves by
# the same vector; only the qk-norm leaves them a small gradient), so bf16
# rounding of their terms reads as 1-3e-2 of their own norm already at
# t2v-tiny on the CPU. The loss: as the SP forward's prediction
# (SP_RING_REL_TOL).
SPT_GRAD_REL_TOL = GRAD_REL_TOL
SPT_LOSS_REL_TOL = SP_RING_REL_TOL
# 16c: cli.finetune --sp_size 1 over NCCL at world size 1, 2 steps at 7,800
# tokens (the checkpoint is the full 1.3B's either way); 16d: the 14B QLoRA
# step at full width, depth cut to SPT_QLORA_LAYERS, Ulysses sp 2.
SPT_CLI_LATENT, SPT_CLI_STEPS = (16, 5, 60, 104), 2
SPT_QLORA_LAYERS = 4


class _GradsOf:
    """An optimizer stand-in for ``make_train_step`` that keeps the
    gradients of ``named``'s tensors (by name) and updates nothing; its
    clip norm is ``make_optimizer``'s (the mesh's with ``comm``)."""

    def __init__(self, named, comm=None):
        from moviigen_tpu_torch.training.train_step import (
            global_norm, mesh_global_norm)

        self.names = list(named)
        self.params = list(named.values())
        self.grads = None
        self.norm_fn = global_norm if comm is None else \
            mesh_global_norm(comm, self.params)

    def step(self, grads, norm=None):
        self.grads = dict(zip(self.names, grads))
        return True


def _sp_pair_case(n, gen, b=2, l=None, shards=None):
    """The ring's pair kernels at ``n`` heads (``b`` batch entries,
    ``l`` tokens cut into ``shards``; by default phase 16a's): for each
    query shard the global stats from the ring's own forward (the carried
    kernel per key shard in the ring's order, each step against the twin's
    step, ``_check_carry``), then each pair's dKV and dQ with those stats
    and the held shard's key count, against the plain twin on the same
    inputs; an empty pair exactly zero; the pairs' sums against the
    one-shot backward kernels over the whole sequence. One dense pair's
    kernels timed (the carried forward's middle step, the stats forward
    as the training's cross-attention and the Ulysses path run it, dKV,
    dQ), with the plain twins, the bounds, SDPA's forward (the forwards'
    library time) and SDPA's forward + backward (the backward kernels').
    The stats forward is checked against its twin on that pair."""
    import torch

    from moviigen_tpu_torch.ops import flash_attention as fa
    from moviigen_tpu_torch.parallel import ring

    l = l or SPT_TOKENS
    shards = shards or SPT_SHARDS
    s = l // shards
    name = f"t_ring_pair_B{b}_L{s}x{shards}_N{n}"
    q, k, v, do = (torch.randn(b, l, n, HEAD_DIM, generator=gen,
                               device=DEVICE, dtype=torch.bfloat16)
                   for _ in range(4))
    # the last batch entry's last key shard empty
    last = b - 1
    k_lens = torch.tensor([l] * last + [l - s], dtype=torch.int32,
                          device=DEVICE)
    cut = [[x[:, i * s:(i + 1) * s].contiguous() for i in range(shards)]
           for x in (q, k, v, do)]
    errs, carry_errs, sums = {}, [], {"dq": {}, "dk": {}, "dv": {}}
    stats = []
    for i in range(shards):
        state = plain = None
        for step in range(shards):
            j = (i - step) % shards
            final = step == shards - 1
            args = (cut[0][i], cut[1][j], cut[2][j],
                    ring._local_klens(k_lens, j, s))
            state = fa.flash_attention_carry_cuda(*args, state, final)
            plain = fa.flash_attention_carry_plain(*args, plain, final)
            carry_errs += _check_carry(f"{name} pair ({i}, {j})", state,
                                       plain)
        # (out, m base 2, l [B, N, Lq]): as the pair backward takes them
        stats.append(state)
        del plain
    for i in range(shards):
        o, m2, l2 = stats[i]
        for j in range(shards):
            kl = ring._local_klens(k_lens, j, s)
            args = (cut[0][i], cut[1][j], cut[2][j], kl, o, m2, l2,
                    cut[3][i])
            got = fa.flash_bwd_cuda(*args)
            want = fa.flash_bwd_plain(*args)
            for what, g, w in zip(("dq", "dk", "dv"), got, want):
                errs[f"({i}, {j}) {what}"] = _check(
                    f"{name} pair ({i}, {j})", what, g, w, GRAD_REL_TOL)
                if j == shards - 1 and (bool(g[last].any()) or bool(
                        w[last].any())):
                    raise RuntimeError(f"{name} pair ({i}, {j}): {what} of "
                                       "the empty key shard is not zero")
            for what, g, key in (("dq", got[0], i), ("dk", got[1], j),
                                 ("dv", got[2], j)):
                sums[what][key] = sums[what].get(key, 0.0) + g.float()
            del got, want
    whole = fa.flash_bwd_cuda(
        q, k, v, k_lens, torch.cat([st[0] for st in stats], dim=1),
        torch.cat([st[1] for st in stats], dim=2).contiguous(),
        torch.cat([st[2] for st in stats], dim=2).contiguous(), do)
    sum_errs = {what: _check(name, f"pairs' {what} vs one-shot",
                             torch.cat([sums[what][i] for i in
                                        range(shards)], dim=1),
                             w.float(), GRAD_REL_TOL)[1]
                for what, w in zip(("dq", "dk", "dv"), whole)}
    del whole, sums
    # the dense pair (0, 0) timed
    q0, k0, v0, do0 = cut[0][0], cut[1][0], cut[2][0], cut[3][0]
    o0, m0, l0 = stats[0]
    ops = fa.bwd_operands(q0, k0, v0, None, o0, m0, l0, do0)
    stats_errs = [_check(f"{name} pair (0, 0) stats", what, g, w,
                         FLASH_REL_TOL)
                  for what, g, w in zip(
                      ("out", "m", "l"),
                      fa.flash_attention_stats_cuda(q0, k0, v0),
                      fa.flash_attention_stats_plain(q0, k0, v0))]
    mid = fa.flash_attention_carry_cuda(q0, cut[1][-1], cut[2][-1],
                                        last=False)
    mid_plain = fa.CarryState(*(x.clone() for x in mid[:3]))
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q0, k0, v0))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_fwd():
        with torch.no_grad():
            return sdpa(qt, kt, vt)

    def sdpa_fwd_bwd():
        out = sdpa(qt, kt, vt)
        return torch.autograd.grad(out, (qt, kt, vt), do0.transpose(1, 2))

    (fwd_b, fwd_by), (dkv_b, dkv_by), (dq_b, dq_by) = train_bounds(
        b, s, s, [s] * b, n=n)
    carry_b, carry_by = carry_bound(b, s, s, n)
    row = dict(
        case=name, B=b, Lq=s, Lk=s, N=n, shards=shards,
        k_lens=k_lens.tolist(), empty_pair=[shards - 1, f"batch {last}"],
        max_abs_err={w: max(e[0] for key, e in errs.items()
                            if key.endswith(w)) for w in ("dq", "dk", "dv")},
        rel_err={w: max(e[1] for key, e in errs.items()
                        if key.endswith(w)) for w in ("dq", "dk", "dv")},
        stats_max_abs_err=max(e[0] for e in stats_errs),
        stats_rel_err=max(e[1] for e in stats_errs),
        carry_max_abs_err=max(e[0] for e in carry_errs),
        carry_rel_err=max(e[1] for e in carry_errs),
        pairs_vs_one_shot_rel_err=sum_errs,
        carry_ms=cuda_ms(lambda: fa.flash_attention_carry_cuda(
            q0, k0, v0, None, mid, False)),
        carry_plain_ms=cuda_ms(lambda: fa.flash_attention_carry_plain(
            q0, k0, v0, None, mid_plain, False), iters=3, warmup=1),
        carry_bound_ms=carry_b, carry_bound_by=carry_by,
        stats_ms=cuda_ms(lambda: fa.flash_attention_stats_cuda(q0, k0, v0)),
        dkv_ms=cuda_ms(lambda: fa.flash_bwd_dkv_cuda(ops)),
        dq_ms=cuda_ms(lambda: fa.flash_bwd_dq_cuda(ops)),
        stats_plain_ms=cuda_ms(lambda: fa.flash_attention_stats_plain(
            q0, k0, v0), iters=3, warmup=1),
        plain_ms=cuda_ms(lambda: fa.flash_bwd_plain(
            q0, k0, v0, None, o0, m0, l0, do0), iters=3, warmup=1),
        stats_library_ms=cuda_ms(sdpa_fwd), stats_library="SDPA forward",
        library_ms=cuda_ms(sdpa_fwd_bwd, iters=5),
        library="SDPA forward + backward (dq, dk, dv)",
        stats_bound_ms=fwd_b, stats_bound_by=fwd_by,
        dkv_bound_ms=dkv_b, dkv_bound_by=dkv_by,
        dq_bound_ms=dq_b, dq_bound_by=dq_by,
        dkv_query_splits=fa.dkv_query_splits(b, n, s, s))
    del q, k, v, do, cut, stats, ops, qt, kt, vt, mid, mid_plain
    torch.cuda.empty_cache()
    return row


def phase_sp_train_pairs(report):
    """(a) The ring's pair kernels at the SP training shapes
    (``_sp_pair_case``, at 12 and 40 heads). Launches here are
    comparisons, not the path's."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(16)
    rows = []
    for n in SPT_PAIR_HEADS:
        rows.append(_sp_pair_case(n, gen))
        log("phase 16a: " + json.dumps(rows[-1]))
    report["sp_train_pairs"] = rows


def _grad_errs(got, want):
    """(norm-relative error of each gradient, a linear's weight and bias
    taken as one tensor under the linear's name; the same of each tensor
    alone)."""
    import torch

    alone, errs = {}, {}
    for name, w in want.items():
        alone[name] = float((got[name].float() - w.float()).norm()
                            / w.float().norm().clamp_min(1e-30))
        owner, _, leaf = name.rpartition(".")
        if leaf == "bias" and f"{owner}.weight" in want:
            continue
        parts = [name] + ([f"{owner}.bias"] if leaf == "weight"
                          and f"{owner}.bias" in want else [])
        g = torch.cat([got[p].float().reshape(-1) for p in parts])
        ref = torch.cat([want[p].float().reshape(-1) for p in parts])
        key = owner if len(parts) > 1 else name
        errs[key] = float((g - ref).norm() / ref.norm().clamp_min(1e-30))
    return errs, alone


def _spt_expected(mode, ring, sp, layers):
    """Launches of one SP train step with per-block remat over all ranks:
    per rank and block, the cross-attention's ``FlashAttention`` (the
    stats forward, again in the recompute, one dKV, one dQ) and the self-
    attention's: the same over N/sp heads (ulysses), or per key shard
    that comes round the ring one carried launch in the forward and one
    in the recompute and one dKV and one dQ in the backward (ring: sp key
    shards; usp: R)."""
    shards = {"ulysses": 0, "ring": sp, "usp": ring}[mode]
    per = layers * sp
    return dict(stats_launches=per * (2 + 2 * (mode == "ulysses")),
                carry_launches=per * 2 * shards,
                dkv_launches=per * (1 + max(shards, 1)),
                dq_launches=per * (1 + max(shards, 1)))


def phase_sp_train_step(report):
    """(b) Cell st1: one t2v-1.3B train step at full width and depth and
    32,760 tokens, the one-process step, then each mode of ``SPT_CASES``
    over thread ranks from the same weights, noise and u (block weights
    as shards gathered per block, per-block remat; one untimed step, then
    one timed with its launches counted and the card's peak memory): the
    loss and every gradient (the shards gathered) against the one-process
    step's."""
    import torch

    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.ops import flash_attention as fa
    from moviigen_tpu_torch.parallel import sharding
    from moviigen_tpu_torch.parallel.comm import (own_trained, run_ranks,
                                                  thread_mesh)
    from moviigen_tpu_torch.training import TrainConfig, make_train_step

    cfg = WAN_CONFIGS[TRAIN_TASK].model
    gen = torch.Generator(device=DEVICE).manual_seed(17)
    model, rope = _train_inputs(cfg, gen)
    batch = {"latents": torch.randn(1, *TRAIN_LATENT, generator=gen,
                                    device=DEVICE),
             "context": torch.randn(1, cfg.text_len, cfg.text_dim,
                                    generator=gen, device=DEVICE)}
    batch["context"][:, PROMPT_LENS[2]:] = 0.0
    noise = torch.randn(batch["latents"].shape, generator=gen, device=DEVICE)
    u = torch.tensor([0.37], device=DEVICE)
    tc = TrainConfig(remat=True)
    one = _GradsOf(dict(model.named_parameters()))
    step = make_train_step(model, tc, rope, one)
    step(batch, noise=noise, u=u)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    want_m = step(batch, noise=noise, u=u)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    rows = {"one_process": dict(
        s=one_s, loss=float(want_m["loss"]),
        grad_norm=float(want_m["grad_norm"]), launches=fa.launch_counts(),
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)}
    log("phase 16b: one process " + json.dumps(rows["one_process"]))
    want = one.grads
    for name, mode, data, ring_n, seq in SPT_CASES:
        comms = thread_mesh(data=data, ring=ring_n, seq=seq)
        ranks = [None] * len(comms)

        def build(comm):
            m = own_trained(sharding.shard_params(
                model, sharding.dit_param_specs(model), comm,
                sharding.shard_axis(comm)))
            cap = _GradsOf(dict(m.named_parameters()), comm)
            ranks[comm.rank] = (make_train_step(m, tc, rope, cap, comm=comm,
                                                sp_mode=mode), cap,
                                sharding.sharded_tensors(m))
            return ranks[comm.rank][0](batch, noise=noise, u=u)

        run_ranks(build, comms)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = run_ranks(lambda c: ranks[c.rank][0](batch, noise=noise,
                                                       u=u), comms)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = fa.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        sp = ring_n * seq
        expected = dict.fromkeys(counts, 0)
        expected.update(_spt_expected(mode, ring_n, sp, cfg.num_layers))
        dims = ranks[0][2]
        got, zero = {}, []
        for pname, w in want.items():
            if pname in dims:
                got[pname] = torch.cat(
                    [ranks[r][1].grads[pname] for r in range(len(comms))
                     if comms[r].coords["data"] == 0], dim=dims[pname])
            else:
                got[pname] = ranks[0][1].grads[pname]
            if not bool(w.abs().max() > 0):
                zero.append(pname)
        errs, alone = _grad_errs(got, want)
        losses = [float(m["loss"]) for m in metrics]
        loss_rel = abs(losses[0] - rows["one_process"]["loss"]) \
            / abs(rows["one_process"]["loss"])
        worst = sorted(errs.items(), key=lambda kv: -kv[1])
        rows[name] = dict(
            sp_mode=mode, data=data, ring=ring_n, seq=seq, s=secs,
            one_process_s=one_s, loss=losses[0], loss_rel_err=loss_rel,
            grad_norm=float(metrics[0]["grad_norm"]), tensors=len(errs),
            max_grad_rel_err=worst[0][1], worst=dict(worst[:4]),
            median_grad_rel_err=statistics.median(errs.values()),
            worst_alone=dict(sorted(alone.items(),
                                    key=lambda kv: -kv[1])[:4]),
            launches=counts, peak_gib=peak,
            sharded_tensors=len(dims))
        log(f"phase 16b: {name} " + json.dumps(rows[name]))
        if len(set(losses)) != 1:
            raise RuntimeError(f"sp train {name}: the ranks' losses differ: "
                               f"{losses}")
        if zero:
            raise RuntimeError(f"sp train {name}: all-zero one-process "
                               f"gradients {zero[:4]}")
        if not loss_rel <= SPT_LOSS_REL_TOL:
            raise RuntimeError(f"sp train {name}: loss {losses[0]} vs "
                               f"{rows['one_process']['loss']}")
        bad = {p: e for p, e in errs.items() if not e <= SPT_GRAD_REL_TOL}
        if bad:
            raise RuntimeError(f"sp train {name}: gradients past "
                               f"{SPT_GRAD_REL_TOL} (norm-relative): "
                               f"{dict(list(bad.items())[:8])}")
        if counts != expected:
            raise RuntimeError(f"sp train {name}: launches {counts}, "
                               f"expected {expected}")
        del ranks, metrics
        torch.cuda.empty_cache()
    report["sp_train"] = rows
    del model, one, want
    torch.cuda.empty_cache()


def phase_sp_train_cli(report):
    """(c) ``cli.finetune --sp_size 1`` in this process under torchrun's
    variables for one rank: NCCL at world size 1, a (1, 1) mesh, so the
    trainer runs its mesh path (the SP forward with one-rank collectives,
    the mesh checkpoint streamed in the one-process layout); t2v-1.3B at
    full width and depth, 2 steps at 7,800 tokens; the final checkpoint
    read back against the trained parameters and optimizer state."""
    import shutil
    import socket

    import torch
    import torch.distributed as dist

    from moviigen_tpu_torch.cli import finetune
    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.ops import flash_attention as fa
    from moviigen_tpu_torch.parallel import distributed
    from moviigen_tpu_torch.parallel.comm import DistComm
    from moviigen_tpu_torch.training.checkpoint import OPT_FILE, PARAMS_FILE
    from moviigen_tpu_torch.utils.safetensors import (load_tensor,
                                                      read_metadata)

    root = pathlib.Path(__file__).resolve().parent / "_smoke_out" / "sp_cli"
    shutil.rmtree(root, ignore_errors=True)
    cfg = WAN_CONFIGS[TRAIN_TASK].model
    data_json = _latent_dataset(root / "data", SPT_CLI_LATENT, 2,
                                cfg.text_dim, 0)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               LOCAL_WORLD_SIZE="1", MASTER_ADDR="localhost",
               MASTER_PORT=str(port))
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        if not distributed.maybe_initialize_distributed(strict=True):
            raise RuntimeError("sp cli: torch.distributed did not start")
        backend, world = dist.get_backend(), dist.get_world_size()
        fa.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with live_head():
            record = finetune.main([
                "--task", TRAIN_TASK, "--device", DEVICE, "--sp_size", "1",
                "--data_json_path", str(data_json), "--num_latent_t",
                str(SPT_CLI_LATENT[1]), "--gradient_checkpointing",
                "--max_train_steps", str(SPT_CLI_STEPS),
                "--checkpointing_steps", "1000", "--output_dir",
                str(root / "out"), "--seed", "0"])
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    counts = fa.launch_counts()
    sites = 2 * cfg.num_layers
    want = dict(dict.fromkeys(fa.COUNTERS, 0),
                stats_launches=2 * sites * SPT_CLI_STEPS,
                dkv_launches=sites * SPT_CLI_STEPS,
                dq_launches=sites * SPT_CLI_STEPS)
    path = pathlib.Path(record["checkpoint"])
    t0 = time.perf_counter()
    model, opt = record["model"], record["optimizer"]
    state = opt.state_dict()
    index = {id(p): i for i, p in enumerate(opt.params)}
    for name, p in model.named_parameters():
        if not torch.equal(load_tensor(str(path / PARAMS_FILE), name),
                           p.detach().cpu()):
            raise RuntimeError(f"sp cli: checkpoint {name} differs")
        for key in ("m", "v"):
            if not torch.equal(load_tensor(str(path / OPT_FILE),
                                           f"{key}/{name}"),
                               state[key][index[id(p)]].cpu()):
                raise RuntimeError(f"sp cli: checkpoint {key}/{name} "
                                   "differs")
    read_s = time.perf_counter() - t0
    meta = read_metadata(str(path / OPT_FILE))
    row = dict(backend=backend, world_size=world,
               mesh=dict(record["comm"].shape), main_s=main_s,
               step_s=record["step_s"], loss=record["loss"],
               launches=counts, checkpoint_save_s=record["checkpoint_s"],
               checkpoint_read_s=read_s,
               checkpoint_gib=sum(f.stat().st_size for f in path.iterdir())
               / 2**30, opt_meta=meta)
    log("phase 16c: " + json.dumps(row))
    report["sp_train_cli"] = row
    if backend != "nccl" or world != 1 or not isinstance(record["comm"],
                                                        DistComm):
        raise RuntimeError(f"sp cli: {backend} at world size {world}, "
                           f"comm {type(record['comm']).__name__}")
    if record["step"] != SPT_CLI_STEPS or not np.isfinite(
            record["loss"]).all():
        raise RuntimeError(f"sp cli: step {record['step']}, loss "
                           f"{record['loss']}")
    if counts != want:
        raise RuntimeError(f"sp cli: launches {counts}, expected {want}")
    if int(meta["count"]) != SPT_CLI_STEPS:
        raise RuntimeError(f"sp cli: optimizer count {meta['count']}")
    del record, model, opt, state
    shutil.rmtree(root)
    torch.cuda.empty_cache()


def phase_sp_train_qlora(report):
    """(d) The 14B QLoRA step under Ulysses sp 2 on thread ranks: t2v-14B
    at full width, depth cut to ``SPT_QLORA_LAYERS``, an int8 base (codes
    and scales sharded, gathered per block), rank-64 adapters with a live
    B replicated, 32,760 tokens, per-block remat: the adapter gradients
    against the one-process step's; the base, gathered, bit-equal to the
    unsharded one and unchanged."""
    import torch

    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.models.wan_model import WanModel
    from moviigen_tpu_torch.ops import flash_attention as fa
    from moviigen_tpu_torch.ops import int8_gemm as ig
    from moviigen_tpu_torch.ops.rope import rope_3d_freqs
    from moviigen_tpu_torch.parallel import sharding
    from moviigen_tpu_torch.parallel.comm import (own_trained, run_ranks,
                                                  thread_mesh)
    from moviigen_tpu_torch.training import TrainConfig, make_train_step

    cfg = WAN_CONFIGS[LORA_TASK].model.replace(num_layers=SPT_QLORA_LAYERS)
    gen = torch.Generator(device=DEVICE).manual_seed(18)
    with live_head():
        model = WanModel(cfg, dtype=torch.float32, device=DEVICE,
                         quant="int8").init_weights(gen)
    model.requires_grad_(False)
    _live_adapters(model, gen)
    base = {n: t.clone() for n, t in model.named_buffers()}
    _, f, h, w = TRAIN_LATENT
    rope = rope_3d_freqs((f, h // 2, w // 2), cfg.head_dim, device=DEVICE)
    batch = {"latents": torch.randn(1, *TRAIN_LATENT, generator=gen,
                                    device=DEVICE),
             "context": torch.randn(1, cfg.text_len, cfg.text_dim,
                                    generator=gen, device=DEVICE)}
    noise = torch.randn(batch["latents"].shape, generator=gen, device=DEVICE)
    u = torch.tensor([0.37], device=DEVICE)
    tc = TrainConfig(remat=True)
    one = _GradsOf({n: p for n, p in model.named_parameters()
                    if p.requires_grad})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want_m = make_train_step(model, tc, rope, one)(batch, noise=noise, u=u)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    comms = thread_mesh(seq=2)
    specs = sharding.dit_param_specs(model)

    def rank(comm):
        m = own_trained(sharding.shard_params(model, specs, comm, "seq"))
        cap = _GradsOf({n: p for n, p in m.named_parameters()
                        if p.requires_grad}, comm)
        metrics = make_train_step(m, tc, rope, cap, comm=comm)(
            batch, noise=noise, u=u)
        with torch.no_grad():  # the base, gathered, as it was
            buffers = dict(m.named_buffers())
            same = all(torch.equal(comm.all_gather(buffers[n], "seq", d),
                                   base[n])
                       for n, d in sharding.sharded_tensors(m).items()
                       if n in buffers)
        return metrics, cap.grads, same

    fa.reset_launch_counts()
    ig.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = run_ranks(rank, comms)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {**fa.launch_counts(), **ig.launch_counts()}
    expected = dict.fromkeys(counts, 0)
    expected.update(_spt_expected("ulysses", 1, 2, SPT_QLORA_LAYERS))
    errs = {}
    for r, (_, grads, _) in enumerate(outs):
        for name, w in one.grads.items():
            errs[f"rank {r} {name}"] = float(
                (grads[name] - w).norm() / w.norm().clamp_min(1e-30))
    unchanged = all(torch.equal(t, base[n])
                    for n, t in model.named_buffers())
    worst = sorted(errs.items(), key=lambda kv: -kv[1])
    row = dict(layers=SPT_QLORA_LAYERS, tokens=32760, quant="int8",
               sp_mode="ulysses", seq=2, s=secs, one_process_s=one_s,
               loss=float(outs[0][0]["loss"]),
               one_process_loss=float(want_m["loss"]),
               adapters=len(one.grads), max_grad_rel_err=worst[0][1],
               worst=dict(worst[:4]),
               median_grad_rel_err=statistics.median(errs.values()),
               base_gathered_equal=all(o[2] for o in outs),
               base_unchanged=unchanged, launches=counts)
    log("phase 16d: " + json.dumps(row))
    report["sp_train_qlora"] = row
    if not (row["base_gathered_equal"] and unchanged):
        raise RuntimeError("sp qlora: the int8 base is not bit-equal")
    bad = {n: e for n, e in errs.items() if not e <= SPT_GRAD_REL_TOL}
    if bad or any(not bool(w.abs().max() > 0) for w in one.grads.values()):
        raise RuntimeError(f"sp qlora: adapter gradients past "
                           f"{SPT_GRAD_REL_TOL}: "
                           f"{dict(list(bad.items())[:6])}")
    if counts != expected:
        raise RuntimeError(f"sp qlora: launches {counts}, expected "
                           f"{expected}")
    del model, outs, one, base
    torch.cuda.empty_cache()


def phase_sp_train(report):
    t0 = time.perf_counter()
    for sub in (phase_sp_train_pairs, phase_sp_train_step,
                phase_sp_train_cli, phase_sp_train_qlora):
        t1 = time.perf_counter()
        sub(report)
        log(f"phase 16: {sub.__name__} {time.perf_counter() - t1:.1f} s")
    log(f"phase 16: {time.perf_counter() - t0:.1f} s")


# Phase 18: the kernels at the shapes the four-card runs of
# tools/sp_serve_cards.py and tools/sp_train_cards.py launch on each rank
# (4 ranks; t2v-14B 40 heads, t2v-1.3B 12; head dim 128), each against its
# plain twin. Phase 13b already holds the r1 shapes of S1, S2, S3 and S5
# (u2, x2, s2, s3).
CARDS = 4
CARDS_FWD = [
    # name, B, Lq, Lk, N
    # S4: data 2 x seq 2, each data rank half the CFG pair, Ulysses 2
    ("c_s4_self_B1_L7800_N20", 1, 7800, 7800, 20),
    ("c_s4_cross_B1_Lq3900_Lk512", 1, 3900, 512, 40),
    # S6: 1280x720x81 (75,600 tokens) under Ulysses 4, CFG batched
    ("c_s6_self_B2_L75600_N10", 2, 75600, 75600, 10),
    ("c_s6_cross_B2_Lq18900_Lk512", 2, 18900, 512, 40),
    # S7: 1920x832x81 (131,040 tokens) under Ulysses 4, CFG batched
    ("c_s7_self_B2_L131040_N10", 2, 131040, 131040, 10),
    # S8: i2v's image cross-attention (257 CLIP tokens) on the Ulysses
    # query shards of r1's shape and of 1280x720x81
    ("c_s8_img_B2_Lq1950_Lk257", 2, 1950, 257, 40),
    ("c_s8_img_B2_Lq18900_Lk257", 2, 18900, 257, 40),
]
CARDS_CARRY = [
    # name, B, key shard, N: a middle step of the ring's carried forward
    # S7 in ring 4: 131,040 tokens padded to 131,072, shards of 32,768
    ("c_s7_ring_B2_L32768x4_N40", 2, 32768, 40),
]
CARDS_TRAIN = [
    # name, B, Lq, Lk, N: the stats forward, dKV and dQ at 32,760 tokens
    # T1 / T2: t2v-14B, Ulysses 4
    ("c_t1_self_B1_L32760_N10", 1, 32760, 32760, 10),
    ("c_t1_cross_B1_Lq8190_Lk512_N40", 1, 8190, 512, 40),
    # T3 (ring 4, USP 2 x 2) and T5 (Ulysses 4): t2v-1.3B, 4 query shards
    ("c_t3_cross_B1_Lq8190_Lk512_N12", 1, 8190, 512, 12),
    # T4: t2v-1.3B, data 2 x seq 2, Ulysses 2
    ("c_t4_self_B1_L32760_N6", 1, 32760, 32760, 6),
    ("c_t4_cross_B1_Lq16380_Lk512_N12", 1, 16380, 512, 12),
    # T5: t2v-1.3B, Ulysses 4
    ("c_t5_self_B1_L32760_N3", 1, 32760, 32760, 3),
]
CARDS_PAIRS = [
    # B, tokens, key shards, N: the ring's pairs with the global stats
    (1, 32760, 4, 12),  # T3 ring 4 (t2v-1.3B)
    (1, 32760, 2, 6),   # T3 USP 2 x 2: Ulysses 2, then a ring of 2
    (1, 32760, 4, 40),  # t2v-14B in ring 4 at 32,760 tokens
    (1, 32760, 2, 20),  # t2v-14B in USP 2 x 2
]
CARDS_INT8 = [
    # S5 w8a8: M = 2 x 7,800 / 4 tokens a rank
    ("c_s5_attn_M3900_K5120_N5120", 3900, 5120, 5120),
    ("c_s5_ffn1_M3900_K5120_N13824", 3900, 5120, 13824),
    ("c_s5_ffn2_M3900_K13824_N5120", 3900, 13824, 5120),
]
CARDS_QUANT = [(3900, 5120), (3900, 13824)]
# phase 17: seconds each tool may take
CARDS_TOOL_TIMEOUT = 3600


def _cards_train_case(name, b, lq, lk, n, gen):
    """The stats forward, dKV and dQ at one shape against their plain
    twins on the same inputs; their times, the plain twins', SDPA's
    (forward; forward + backward) and their bounds."""
    import torch

    from moviigen_tpu_torch.ops import flash_attention as fa

    q, k, v = (torch.randn(b, length, n, HEAD_DIM, generator=gen,
                           device=DEVICE, dtype=torch.bfloat16)
               for length in (lq, lk, lk))
    got = fa.flash_attention_stats_cuda(q, k, v)
    want = fa.flash_attention_stats_plain(q, k, v)
    stats_errs = [_check(name, what, g, w, FLASH_REL_TOL)
                  for what, g, w in zip(("out", "m", "l"), got, want)]
    out, m, l_ = want
    do = torch.randn(out.shape, generator=gen, device=DEVICE,
                     dtype=torch.bfloat16)
    ops = fa.bwd_operands(q, k, v, None, out, m, l_, do)
    dk, dv = fa.flash_bwd_dkv_cuda(ops)
    dq = fa.flash_bwd_dq_cuda(ops)
    wdq, wdk, wdv = fa.flash_bwd_plain(q, k, v, None, out, m, l_, do)
    errs = {what: _check(name, what, g, w, GRAD_REL_TOL)
            for what, g, w in (("dq", dq, wdq), ("dk", dk, wdk),
                               ("dv", dv, wdv))}
    del dk, dv, dq, wdq, wdk, wdv, got
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_fwd():
        with torch.no_grad():
            return sdpa(qt, kt, vt)

    def sdpa_fwd_bwd():
        o = sdpa(qt, kt, vt)
        return torch.autograd.grad(o, (qt, kt, vt), do.transpose(1, 2))

    (fwd_b, fwd_by), (dkv_b, dkv_by), (dq_b, dq_by) = train_bounds(
        b, lq, lk, [lk] * b, n=n)
    row = dict(
        case=name, B=b, Lq=lq, Lk=lk, N=n,
        max_abs_err={w: e[0] for w, e in errs.items()},
        rel_err={w: e[1] for w, e in errs.items()},
        stats_max_abs_err=max(e[0] for e in stats_errs),
        stats_rel_err=max(e[1] for e in stats_errs),
        stats_ms=cuda_ms(lambda: fa.flash_attention_stats_cuda(q, k, v)),
        dkv_ms=cuda_ms(lambda: fa.flash_bwd_dkv_cuda(ops)),
        dq_ms=cuda_ms(lambda: fa.flash_bwd_dq_cuda(ops)),
        stats_plain_ms=cuda_ms(lambda: fa.flash_attention_stats_plain(
            q, k, v), iters=1, warmup=0),
        plain_ms=cuda_ms(lambda: fa.flash_bwd_plain(
            q, k, v, None, out, m, l_, do), iters=1, warmup=0),
        stats_library_ms=cuda_ms(sdpa_fwd), stats_library="SDPA forward",
        library_ms=cuda_ms(sdpa_fwd_bwd, iters=5),
        library="SDPA forward + backward (dq, dk, dv)",
        stats_bound_ms=fwd_b, stats_bound_by=fwd_by,
        dkv_bound_ms=dkv_b, dkv_bound_by=dkv_by,
        dq_bound_ms=dq_b, dq_bound_by=dq_by,
        dkv_query_splits=fa.dkv_query_splits(b, n, lq, lk))
    del q, k, v, qt, kt, vt, out, m, l_, do, ops, want
    torch.cuda.empty_cache()
    return row


def _spare_grid(name, q, k, v, state, full):
    """The ring's step at the grid it launches while a shift is in flight
    (``ring.RING_SPARE_SMS`` SMs left to NCCL) from a copy of ``state``
    against ``full``, the same step at the full grid: every field of the
    state bit for bit (which block walks an item must not change its
    arithmetic); timed on ``state``. Returns the row's fields."""
    import torch

    from moviigen_tpu_torch.ops import flash_attention as fa
    from moviigen_tpu_torch.parallel.ring import RING_SPARE_SMS

    got = fa.flash_attention_carry_cuda(
        q, k, v, None, fa.CarryState(*(x.clone() for x in state)), False,
        spare_sms=RING_SPARE_SMS)
    if not all(torch.equal(a, b) for a, b in zip(got, full)):
        raise RuntimeError(f"{name}: the step at sms - {RING_SPARE_SMS} "
                           "blocks is not the full grid's bit for bit")
    return dict(spare_sms=RING_SPARE_SMS, spare_bit_equal_full_grid=True,
                spare_ms=cuda_ms(lambda: fa.flash_attention_carry_cuda(
                    q, k, v, None, state, False, spare_sms=RING_SPARE_SMS)))


def _carry_step_case(name, b, shard, n, gen):
    """A middle step of the ring's carried forward at a four-card shape:
    the state from a first step over one key shard, then the step over
    the next against its plain twin's from the same state
    (``_check_carry``), and at the grid the ring launches while a shift is
    in flight against the full grid's, bit for bit (``_spare_grid``),
    timed beside the twin, SDPA over the pair and the bound
    (``carry_bound``)."""
    import torch

    from moviigen_tpu_torch.ops import flash_attention as fa

    q, k0, k1, v0, v1 = (torch.randn(b, shard, n, HEAD_DIM, generator=gen,
                                     device=DEVICE, dtype=torch.bfloat16)
                         for _ in range(5))
    state = fa.flash_attention_carry_cuda(q, k0, v0, last=False)
    kept = fa.CarryState(*(x.clone() for x in state))
    got = fa.flash_attention_carry_cuda(
        q, k1, v1, None, fa.CarryState(*(x.clone() for x in kept)), False)
    spare = _spare_grid(name, q, k1, v1,
                        fa.CarryState(*(x.clone() for x in kept)), got)
    want = fa.flash_attention_carry_plain(q, k1, v1, None, kept, False)
    errs = _check_carry(name, got, want)
    del got, want, k0, v0
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k1, v1))
    bound_ms, bound_by = carry_bound(b, shard, shard, n)
    row = dict(
        case=name, kernel="carry", B=b, Lq=shard, Lk=shard, N=n,
        max_abs_err=max(e[0] for e in errs),
        rel_err=max(e[1] for e in errs),
        ms=cuda_ms(lambda: fa.flash_attention_carry_cuda(
            q, k1, v1, None, state, False)),
        plain_ms=cuda_ms(lambda: fa.flash_attention_carry_plain(
            q, k1, v1, None, kept, False), iters=1, warmup=0),
        library_ms=cuda_ms(lambda: torch.nn.functional
                           .scaled_dot_product_attention(qt, kt, vt)),
        library="SDPA forward", bound_ms=bound_ms, bound_by=bound_by,
        stats_ms=cuda_ms(lambda: fa.flash_attention_stats_cuda(q, k1, v1)),
        **spare)
    del q, k1, v1, qt, kt, vt, state, kept
    torch.cuda.empty_cache()
    return row


def phase_cards_kernels(report):
    """18. The kernels at the shapes the four-card runs launch
    (``CARDS_*``), on this one card, each against its plain twin on the
    same inputs, timed beside its bound and its library call: the forward
    (S4, S6, S7's Ulysses, S8's image cross-attention), the ring's carried
    step at S7's ring 4 shards, the stats forward, dKV and dQ (T1-T5), the
    ring's pairs with the global stats and an empty key shard (T3, and the
    14B's ring and USP at 32,760 tokens), the int8 GEMM (bit-equal, three
    bias modes) and the activation quantization (bit-equal) of S5's W8A8
    ranks. Launches here are comparisons, not a path's."""
    import torch

    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(18)
    fwd, carry, train, pairs = [], [], [], []
    with torch.no_grad():
        for name, b, lq, lk, n in CARDS_FWD:
            q = torch.randn(b, lq, n, HEAD_DIM, generator=gen, device=DEVICE,
                            dtype=torch.bfloat16)
            k, v = (torch.randn(b, lk, n, HEAD_DIM, generator=gen,
                                device=DEVICE, dtype=torch.bfloat16)
                    for _ in range(2))
            fwd.append(_sp_fwd_case(name, q, k, v, plain_iters=1))
            log("phase 18: " + json.dumps(fwd[-1]))
            del q, k, v
            torch.cuda.empty_cache()
        for name, b, shard, n in CARDS_CARRY:
            carry.append(_carry_step_case(name, b, shard, n, gen))
            log("phase 18: " + json.dumps(carry[-1]))
    for name, b, lq, lk, n in CARDS_TRAIN:
        train.append(_cards_train_case(name, b, lq, lk, n, gen))
        log("phase 18: " + json.dumps(train[-1]))
    for b, tokens, shards, n in CARDS_PAIRS:
        pairs.append(_sp_pair_case(n, gen, b=b, l=tokens, shards=shards))
        log("phase 18: " + json.dumps(pairs[-1]))
    int8_kernel_cases(report, CARDS_INT8, key="cards_int8", phase="18")
    quantize_kernel_cases(report, CARDS_QUANT, key="cards_quantize",
                          phase="18")
    report["cards_kernels"] = dict(fwd=fwd, carry=carry,
                                   train=train + pairs)
    torch.cuda.empty_cache()
    log(f"phase 18: {time.perf_counter() - t0:.1f} s")


def phase_cards(report):
    """17. (only when asked) ``tools/sp_serve_cards.py`` and
    ``tools/sp_train_cards.py`` at their defaults: the runs S0-S8 and
    T1-T5 on four cards, one rank per card over NCCL. T1 runs last, in a
    launch of its own: its final checkpoint (the 14B's weights and AdamW
    moments, 160 GiB) needs a disk that holds it, and a tool stops at its
    first failed run. Raises with fewer than four cards visible, and when
    any of the three fails (all three run)."""
    import torch

    count = torch.cuda.device_count()
    if count < CARDS:
        raise RuntimeError(f"phase 17 needs {CARDS} cards; {count} visible")
    torch.cuda.empty_cache()  # this process' cache on card 0
    root = pathlib.Path(__file__).resolve().parent
    rows, failed = {}, []
    for tool, args in (("sp_serve_cards.py", []),
                       ("sp_train_cards.py", ["--runs", "T2,T3,T5,T4"]),
                       ("sp_train_cards.py", ["--runs", "T1"])):
        name = " ".join([tool] + args)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(root / "tools" / tool), *args], cwd=root,
            capture_output=True, text=True, timeout=CARDS_TOOL_TIMEOUT)
        rows[name] = []
        for line in proc.stdout.splitlines():
            log(f"phase 17: {tool}: {line}")
            if line.startswith("{"):
                rows[name].append(json.loads(line))
        log(f"phase 17: {name} exited {proc.returncode} in "
            f"{time.perf_counter() - t0:.1f} s")
        if proc.returncode:
            log(proc.stderr[-8000:])
            failed.append(name)
    report["cards"] = rows
    if failed:
        raise RuntimeError(f"phase 17: {failed} failed")


def _cards_launches(report, key):
    """A kernel's launches in each phase-17 run (rank 0's)."""
    out = {}
    for rows in report.get("cards", {}).values():
        for row in rows:
            if isinstance(row.get("launches"), dict) and "run" in row:
                tag = " ".join(str(x) for x in (row["run"],
                                                row.get("sp_mode", ""))
                               if x)
                out[f"four cards {tag}, rank 0 (phase 17)"] = \
                    row["launches"].get(key, 0)
    return out


PHASES = {1: phase_setup, 2: phase_kernels, 3: phase_dit,
          4: phase_main_path, 5: phase_profile, 6: phase_train,
          7: phase_train_profile, 8: phase_quant_serving,
          9: phase_quant_profile, 10: phase_preprocess, 11: phase_lora,
          12: phase_i2v, 13: phase_sp, 14: phase_utils,
          15: phase_qlora_profile, 16: phase_sp_train, 17: phase_cards,
          18: phase_cards_kernels}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="1,2,3,4,6,8,10,11,12,13,14,16,18",
                    help="comma-separated phases to run (default: all "
                         "but the profiles, 5, 7, 9 and 15, and the "
                         "four-card runs, 17)")
    args = ap.parse_args(argv)
    phases = sorted({int(p) for p in args.phases.split(",")})

    # the prompt rewriter of phase 14 must find its weights locally or
    # fail: nothing here may reach the Hugging Face hub
    os.environ["HF_HUB_OFFLINE"] = "1"
    os.environ["TRANSFORMERS_OFFLINE"] = "1"
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    import moviigen_tpu_torch  # noqa: F401  (fails outside the repo)

    # the phases that use 8b's checkpoint directory after phase 8
    report = {"ckpt_keepers": {13, 14} & set(phases)}
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
