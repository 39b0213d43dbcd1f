#!/usr/bin/env python3
"""Sequence-parallel serving across cards: the pipeline of
``cli.generate`` under ``torchrun``, one rank per card over NCCL, held
against the same request on one card.

    python3 tools/sp_serve_cards.py                       # 4 cards
    python3 tools/sp_serve_cards.py --runs S1,S6          # some runs
    python3 tools/sp_serve_cards.py --device cpu --task t2v-tiny \\
        --ranks 2 --frame_num 5 --sample_steps 2 \\
        --s6_size 832*480 --s6_frame_num 5                # 2 gloo ranks

One ``torchrun --standalone`` launch of ``--ranks`` ranks (NCCL on cards,
gloo with ``--device cpu``) runs every run of ``--runs`` in turn, each
over a mesh that ``cli.generate.build_mesh`` lays from its flags (N =
``--ranks``):

- S1: ``--ulysses_size N --dit_fsdp --t5_fsdp`` (how
  ``scripts/inference.sh`` serves the 14B); gate: latents and video
  bit-equal to one card;
- S2: ``--ring_size N``; gate: latents within 5e-3 of their norm;
- S3: ``--ulysses_size N/2 --ring_size 2`` (USP); the same gate;
- S4: ``--ulysses_size N/2`` over N ranks: data 2 (the CFG pair) × seq
  N/2; the same gate, and whether the latents are also bit-equal;
- S5: S1's flags with ``--quant int4``, then ``--quant w8a8`` (the int8
  GEMM and the activation quantization kernels), each against one card
  under the same ``--quant``; gate: bit-equal;
- S6: on S1's pipeline, ``scripts/inference.sh``'s request (1280×720, 81
  frames: ``--s6_warmup`` + ``--s6_timed`` UniPC steps, timed as
  ``bench_torch.py`` times them, then rank 0's decode); gate: a finite
  video of the request's shape in [-1, 1].

S1-S5 answer the request r1 (``--size``, ``--frame_num``,
``--sample_steps``, ``--guide_scale``; 832×480, 17 frames, 4 steps at
guide scale 5: 7,800 tokens, CFG batched). The one-card references run first, each on one rank's card with
no mesh, several at once: the bf16 one on rank 0 and again on the next
free rank (the two must be the same bits: the cards' generators agree),
then one per ``--quant`` the runs need. Before a mesh pipeline cuts its
shards, every rank's checksum of the full weights it drew from the seed
must be every other rank's, and the one-card reference's. The weights are
random from the seed, the DiT's head drawn too (``cards.
draw_live_heads``: with the zero head of ``init_weights`` the prediction
is zero whatever the blocks compute); the prompt is tokenized by the hash
tokenizer (the same ids on every rank: ``PYTHONHASHSEED`` is fixed for
the launch).

Every run's record is one JSON line (seconds, errors against one card,
launches of rank 0's request, every rank's peak GiB); the tool prints
them, then every card's name and power limit as ``nvidia-smi`` prints
them. It fails (non-zero exit) if the launch, a rank, a check or a gate
fails; a failed run ends the launch, and no later run is tried.
"""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import statistics
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from tools import cards  # noqa: E402

ROOT = cards.ROOT
OUT = ROOT / "_smoke_out" / "sp_serve"  # --out_dir
PROMPT = ("Two anthropomorphic cats in comfy boxing gear and bright gloves "
          "fight intensely on a spotlighted stage.")
RUNS = ("S1", "S6", "S2", "S3", "S4", "S5")
# ring and USP sum the attention over key shards in another order and in
# fp32 merges (PR 12's gate on thread ranks)
NORM_TOL = 5e-3
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
CLIP_STEPS = 50


def layouts(n: int) -> dict:
    """run → (generate flags, quant, gate) for ``n`` ranks."""
    fsdp = ["--ulysses_size", str(n), "--dit_fsdp", "--t5_fsdp"]
    out = {"S1": (fsdp, None, "bit-equal"),
           "S2": (["--ring_size", str(n)], None, NORM_TOL)}
    if n >= 4 and n % 2 == 0:
        out["S3"] = (["--ulysses_size", str(n // 2), "--ring_size", "2"],
                     None, NORM_TOL)
        out["S4"] = (["--ulysses_size", str(n // 2)], None, NORM_TOL)
    out["S5_int4"] = (fsdp + ["--quant", "int4"], "int4", "bit-equal")
    out["S5_w8a8"] = (fsdp + ["--quant", "w8a8"], "w8a8", "bit-equal")
    return out


def _expand(runs, n):
    """The runs of ``--runs`` with S5 as its two quant modes, in order;
    raises on a run that needs more ranks."""
    table = layouts(n)
    out = []
    for run in runs:
        if run == "S6":
            continue  # rides on S1's pipeline
        names = ["S5_int4", "S5_w8a8"] if run == "S5" else [run]
        for name in names:
            if name not in table:
                raise SystemExit(f"{run} needs at least 4 ranks (an even "
                                 f"count); --ranks is {n}")
            out.append(name)
    if "S6" in runs and "S1" not in runs:
        raise SystemExit("S6 runs on S1's pipeline: add S1 to --runs")
    return out


# ------------------------------------------------------------- the worker


def _free(device):
    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _counts():
    from moviigen_tpu_torch.ops import flash_attention, int8_gemm

    return {**flash_attention.launch_counts(), **int8_gemm.launch_counts()}


def _reset_counts():
    from moviigen_tpu_torch.ops import flash_attention, int8_gemm

    flash_attention.reset_launch_counts()
    int8_gemm.reset_launch_counts()


def _request(pipe, args):
    """r1 through ``generate``: (latent [z, F', H', W'] numpy, video
    numpy on the output rank else None, the pipeline's timings)."""
    import torch

    size = tuple(int(v) for v in args.size.split("*"))
    latent = pipe.generate(PROMPT, size=size, frame_num=args.frame_num,
                           sampling_steps=args.sample_steps,
                           guide_scale=args.guide_scale, seed=args.seed,
                           return_latents=True)
    video = pipe.decode_request(torch.from_numpy(latent)[None]
                                .to(pipe.device))
    return latent, video, dict(pipe.timings)


def _rel(got, want):
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return (float(np.linalg.norm(got - want) / np.linalg.norm(want)),
            float(np.abs(got - want).max()))


def _references(args, jobs, rank, world, device):
    """This rank's share of the one-card requests (``jobs``: a quant mode
    each), each written to ``ref<i>.npz`` with its record."""
    import numpy as np

    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.pipelines.text2video import WanT2V

    for i, quant in enumerate(jobs):
        if i % world != rank:
            continue
        t0 = time.perf_counter()
        pipe = WanT2V(WAN_CONFIGS[args.task], device=device, quant=quant)
        _sync(device)
        init_s = time.perf_counter() - t0
        drawn = cards.checksum(pipe.t5, pipe.vae_params, pipe.dit).tolist()
        latent, video, timings = _request(pipe, args)
        np.savez(OUT / f"ref{i}.npz", latent=latent, video=video)
        (OUT / f"ref{i}.json").write_text(json.dumps(dict(
            quant=quant, rank=rank, init_s=init_s, weights=drawn,
            step_s=timings["step_s"], t5_s=timings["t5_s"],
            decode_s=timings.get("decode_s"))))
        del pipe
        _free(device)


def _gate(gate, rel, equal):
    return equal if gate == "bit-equal" else rel <= gate


def worker(argv):
    global OUT
    args = _parser().parse_args(argv)
    OUT = pathlib.Path(args.out_dir)
    import numpy as np
    import torch.distributed as dist

    from moviigen_tpu_torch.cli import generate
    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.models import tokenizer
    from moviigen_tpu_torch.parallel import distributed
    from moviigen_tpu_torch.pipelines import text2video
    from moviigen_tpu_torch.pipelines.text2video import WanT2V

    if not distributed.maybe_initialize_distributed(device=args.device):
        raise RuntimeError("no process group: launch the workers with "
                           "torchrun")
    rank, world = dist.get_rank(), dist.get_world_size()
    device = distributed.local_device(args.device)
    # random weights: the prompt's ids need only be the same everywhere
    tokenizer._huggingface_or_none = lambda **kwargs: None
    cards.draw_live_heads()
    drawn = {}
    shard = text2video.shard_pipeline_params

    def checked_shard(mesh, t5, vae_params, dit):
        drawn["weights"] = cards.same_on_every_rank(
            cards.checksum(t5, vae_params, dit), "the pipeline's weights")
        return shard(mesh, t5, vae_params, dit)

    text2video.shard_pipeline_params = checked_shard
    runs = args.runs.split(",")
    names = _expand(runs, world)
    table = layouts(world)
    quants = list(dict.fromkeys(table[n][1] for n in names))
    # the bf16 request a second time, on another card, where one is free
    twice = None in quants and world > len(quants)
    jobs = quants + [None] * twice
    ref_of = {q: quants.index(q) for q in quants}

    def write(record):
        if rank == 0:
            with open(OUT / "records.jsonl", "a") as f:
                f.write(json.dumps(record) + "\n")
            print(json.dumps(record), flush=True)

    t0 = time.perf_counter()
    _references(args, jobs, rank, world, device)
    dist.barrier()
    refs = [dict(np.load(OUT / f"ref{i}.npz", allow_pickle=True),
                 **json.loads((OUT / f"ref{i}.json").read_text()))
            for i in range(len(jobs))]
    if twice:
        first = refs[ref_of[None]]
        same = (np.array_equal(refs[-1]["latent"], first["latent"])
                and np.array_equal(refs[-1]["video"], first["video"])
                and refs[-1]["weights"] == first["weights"])
        write(dict(run="one-card references", seconds=time.perf_counter()
                   - t0, jobs=[str(q) for q in jobs],
                   ranks=[r["rank"] for r in refs],
                   init_s=[r["init_s"] for r in refs],
                   step_s=[r["step_s"] for r in refs],
                   bf16_on_two_cards_bit_equal=same))
        if not same:
            raise RuntimeError(
                "the one-card bf16 request differs between rank "
                f"{first['rank']}'s card and rank {refs[-1]['rank']}'s")

    for name in names:
        flags, quant, gate = table[name]
        # the CLI's flags for the mesh and the weights; the request is
        # the tool's own (r1 is not in the CLI's size table at t2v-tiny)
        gargs = generate._parse_args(
            ["--task", args.task, "--device", args.device, *flags])
        generate._validate_args(gargs)
        cards.reset_peak(device)
        t0 = time.perf_counter()
        mesh, sp_mode = generate.build_mesh(gargs)
        pipe = WanT2V(WAN_CONFIGS[args.task], device=device, quant=quant,
                      residual_dtype=gargs.residual_dtype, mesh=mesh,
                      sp_mode=sp_mode)
        _sync(device)
        init_s = time.perf_counter() - t0
        init_peak = cards.peak_gib(device)
        ref = refs[ref_of[quant]]
        if drawn.pop("weights") != ref["weights"]:
            raise RuntimeError(f"{name}: the mesh's weights are not the "
                               "one-card reference's")
        _reset_counts()
        latent, video, timings = _request(pipe, args)
        launches = _counts()
        rel, max_abs = _rel(latent, ref["latent"])
        equal = bool(np.array_equal(latent, ref["latent"]))
        video_equal = video_rel = None
        if video is not None:  # rank 0's
            video_equal = bool(np.array_equal(video, ref["video"]))
            video_rel = _rel(video, ref["video"])[0]
        peaks = cards.gather_floats([init_peak, cards.peak_gib(device)],
                                    device)
        # bit-equal latents decode to the same video bits
        ok = _gate(gate, rel, equal) and (gate != "bit-equal"
                                          or video_equal is not False)
        record = dict(
            run=name, flags=flags, mesh=dict(mesh.shape), sp_mode=sp_mode,
            quant=quant or "bf16", tokens=int(np.prod(latent.shape[1:]))
            // 4, guide_scale=args.guide_scale, init_s=init_s, t5_s=timings["t5_s"],
            step_s=timings["step_s"], decode_s=timings.get("decode_s"),
            ref_step_s=ref["step_s"], ref_rank=ref["rank"],
            latent_rel_err=rel, latent_max_abs_err=max_abs,
            latent_bit_equal=equal, video_bit_equal=video_equal,
            video_rel_err=video_rel, gate=gate,
            ok=bool(ok), launches=launches,
            init_peak_gib=[p[0] for p in peaks],
            peak_gib=[p[1] for p in peaks])
        write(record)
        if not ok:
            raise RuntimeError(f"{name}: gate {gate} failed: latents "
                               f"{rel:.3e} of their norm off one card's "
                               f"(bit-equal {equal}, video {video_equal})")
        if name == "S1" and "S6" in runs:
            _inference_sh(pipe, args, init_s, device, write)
        del pipe, mesh
        _free(device)
    dist.barrier()
    dist.destroy_process_group()


def _inference_sh(pipe, args, init_s, device, write):
    """S6: ``scripts/inference.sh``'s request on S1's pipeline."""
    import numpy as np

    from bench_torch import dit_flops
    from moviigen_tpu_torch.pipelines.text2video import (
        compute_target_shape_and_seq_len)

    size = tuple(int(v) for v in args.s6_size.split("*"))
    steps = args.s6_warmup + args.s6_timed
    _, tokens, _ = compute_target_shape_and_seq_len(pipe.config, size,
                                                    args.s6_frame_num)
    _free(device)
    cards.reset_peak(device)
    _reset_counts()
    video = pipe.generate(PROMPT, size=size, frame_num=args.s6_frame_num,
                          sampling_steps=steps, seed=args.seed)
    launches = _counts()
    t = dict(pipe.timings)
    peaks = cards.gather_floats([cards.peak_gib(device)], device)
    s_step = statistics.median(t["step_s"][args.s6_warmup:])
    world = pipe.mesh.size
    flops = dit_flops(pipe.config.model, tokens, batch=2)
    record = dict(run="S6", size=args.s6_size, frames=args.s6_frame_num,
                  tokens=tokens, mesh=dict(pipe.mesh.shape),
                  cfg="batched (the mesh's rule)", init_s=init_s,
                  t5_s=t["t5_s"], step_s=t["step_s"], s_per_step=s_step,
                  mfu_per_card=flops / s_step / world / PEAK_BF16_FLOPS
                  if pipe.device.type == "cuda" else None,
                  peak_gib=[p[0] for p in peaks], launches=launches)
    ok = True
    if video is not None:  # rank 0 decodes
        want = (3, args.s6_frame_num, size[1], size[0])
        finite = bool(np.isfinite(video).all())
        ok = (video.shape == want and finite
              and float(video.min()) >= -1.0 and float(video.max()) <= 1.0)
        record.update(decode_s=t["decode_s"], video_shape=list(video.shape),
                      video_finite=finite, video_min=float(video.min()),
                      video_max=float(video.max()),
                      video_std=float(video.std()),
                      min_per_clip_50=(t["t5_s"] + CLIP_STEPS * s_step
                                       + t["decode_s"]) / 60, ok=ok)
    write(record)
    if not ok:
        raise RuntimeError(f"S6: the video fails its checks: {record}")


# --------------------------------------------------------------- the tool


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", default="t2v-14B")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=4,
                    help="ranks (one card each)")
    ap.add_argument("--runs", default=",".join(RUNS))
    ap.add_argument("--size", default="832*480", help="r1's W*H")
    ap.add_argument("--frame_num", type=int, default=17)
    ap.add_argument("--sample_steps", type=int, default=4)
    ap.add_argument("--guide_scale", type=float, default=5.0,
                    help="r1's CFG guide scale (the CLI's "
                         "--sample_guide_scale)")
    ap.add_argument("--s6_size", default="1280*720")
    ap.add_argument("--s6_frame_num", type=int, default=81)
    ap.add_argument("--s6_warmup", type=int, default=1)
    ap.add_argument("--s6_timed", type=int, default=3)
    ap.add_argument("--out_dir", default=str(OUT),
                    help="where the runs write (emptied first)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--timeout", type=float, default=1200.0,
                    help="seconds the launch may take")
    return ap


def main(argv=None):
    global OUT
    args = _parser().parse_args(argv)
    OUT = pathlib.Path(args.out_dir)
    _expand(args.runs.split(","), args.ranks)  # refuse before launching
    import shutil

    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    if args.device != "cpu":
        # built once here, not by every rank at its first launch
        from moviigen_tpu_torch import kernels

        kernels.build(kernels.KERNELS)
    worker_args = [a for a in (argv if argv is not None else sys.argv[1:])]
    seconds = cards.launch(pathlib.Path(__file__).resolve(), worker_args,
                           args.ranks, OUT / "launch.log", args.timeout)
    records = [json.loads(line) for line in
               (OUT / "records.jsonl").read_text().splitlines()]
    for record in records:
        print(json.dumps(record), flush=True)
    done = {r["run"] for r in records}
    want = set(_expand(args.runs.split(","), args.ranks)) | (
        {"S6"} & set(args.runs.split(",")))
    if not want <= done or not all(r.get("ok", True) for r in records):
        raise SystemExit(f"runs missing or failed: {sorted(want - done)}")
    print(json.dumps({"launch_s": seconds, "ranks": args.ranks,
                      "device": args.device}), flush=True)
    if args.device != "cpu":
        for line in cards.card_lines():
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    if "--worker" in sys.argv:
        worker([a for a in sys.argv[1:] if a != "--worker"])
    else:
        sys.exit(main())
