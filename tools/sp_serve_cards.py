#!/usr/bin/env python3
"""Sequence-parallel serving across cards: the pipeline of
``cli.generate`` under ``torchrun``, one rank per card over NCCL, held
against the same request on one card.

    python3 tools/sp_serve_cards.py                       # 4 cards
    python3 tools/sp_serve_cards.py --runs S1,S6          # some runs
    python3 tools/sp_serve_cards.py --runs S0 --ranks 1   # one card
    python3 tools/sp_serve_cards.py --device cpu --task t2v-tiny \\
        --i2v_task i2v-tiny --small_clip --ranks 2 --frame_num 5 \\
        --sample_steps 2 --s6_size 832*480 --s6_frame_num 5  # 2 gloo ranks

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
  video of the request's shape in [-1, 1];
- S7: the 1080p request (``--s7_size``, ``--s7_frame_num``,
  ``--s7_steps``: 1920×832×81, 131,040 tokens, 2 UniPC steps at r1's
  guide scale) in S1's layout (gate: bit-equal) and in S2's (ring; gate:
  5e-3), each against the same request on one card with its CFG pair run
  as one B = 2 forward, as the mesh runs it; one card serves this length
  as two B = 1 forwards (``text2video.cfg_batched``), which round
  differently: that request is run too, and the records give each
  layout's difference from it and the one card's from itself
  (``--s7_unchecked``: S7 runs with neither, and its gate is a finite
  latent and video);
- S8: i2v (``--i2v_task``) in S1's layout at r1's shape, its
  conditioning image drawn from ``--seed`` (``bench_torch.first_frame``);
  gate: bit-equal to one card's ``WanI2V``, and ``clip_fea`` and ``y``
  the same on every rank and on the one card; then on its pipeline the
  1280×720×81 request timed as S6 (``--s8_size``, ``--s8_frame_num``,
  ``--s6_warmup`` + ``--s6_timed`` steps);
- S0: no mesh: r1 on one card with every self-attention's keys and
  values rolled by half the sequence (the same attention, its keys in
  another order and other tiles), against r1 on one card as it runs:
  the floor of a change of key order. No gate.

S1-S5 answer the request r1 (``--size``, ``--frame_num``,
``--sample_steps``, ``--guide_scale``; 832×480, 17 frames, 4 steps at
guide scale 5: 7,800 tokens, CFG batched). The one-card references run
first, each on one rank's card with no mesh, several at once: one per
request, ``--quant``, CFG pairing (S7) and key order (S0) the runs need,
and the bf16 r1 again on a free rank where there is one (the two must be
the same bits: the cards' generators agree). Before a mesh pipeline cuts its
shards, every rank's checksum of the full weights it drew from the seed
must be every other rank's, and the one-card reference's. The weights are
random from the seed, the DiT's head drawn too (``cards.
draw_live_heads``: with the zero head of ``init_weights`` the prediction
is zero whatever the blocks compute); the prompt is tokenized by the hash
tokenizer (the same ids on every rank: ``PYTHONHASHSEED`` is fixed for
the launch).

With ``--profile`` every rank traces one denoise step of each mesh run's
request (``PROFILE_STEP``, the second) through ``utils/profiling.trace``
(the Chrome traces under ``<out_dir>/profile/<run>/rank<r>``), and the
run's record gains ``profile``, each rank's ``cards.profile_summary``:
device ms of compute and of NCCL, NCCL ms under compute, exposed NCCL ms
(in all, per block, by NCCL kernel) and the idle share. Rank 1 holds the
most key shards in ring 4. The traced step's seconds include the
tracer's cost while it records; opening and closing the trace fall
between steps.

Every run's record is one JSON line (seconds, errors against one card,
launches of rank 0's request, every rank's peak GiB, the largest
prediction of the DiT, which a zero head would make 0); the tool prints
them, then every card's name and power limit as ``nvidia-smi`` prints
them. It fails (non-zero exit) if the launch, a rank, a check or a gate
fails; a failed run ends the launch, and no later run is tried.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
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
RUNS = ("S0", "S1", "S6", "S8", "S7", "S2", "S3", "S4", "S5")
# ring and USP sum the attention over key shards in another order and in
# fp32 merges (PR 12's gate on thread ranks)
NORM_TOL = 5e-3
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
CLIP_STEPS = 50
I2V_CLIP_STEPS = 40
# the caching allocator grows segments in place: S7's one-card reference
# with its CFG pair batched (131,040 tokens, B = 2) ran out of memory in
# a launch at 57.65 GiB allocated with 17.00 GiB cached in fragments
ALLOC_ENV = {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
# --small_clip: a two-block CLIP tower with the full one's output (257
# tokens of width 1280), for the i2v DiT on the CPU
SMALL_CLIP = dict(image_size=16, patch_size=1, mlp_ratio=1, num_layers=2)
PROFILE_STEP = 1  # --profile traces the second denoise step


def layouts(n: int) -> dict:
    """run → (generate flags, request, quant, gate) for ``n`` ranks; the
    request is r1 (``"r1"``), the 1080p one (``"c1"``) or r1's shape
    under i2v (``"i2v"``)."""
    fsdp = ["--ulysses_size", str(n), "--dit_fsdp", "--t5_fsdp"]
    ring = ["--ring_size", str(n)]
    out = {"S1": (fsdp, "r1", None, "bit-equal"),
           "S2": (ring, "r1", None, NORM_TOL)}
    if n >= 4 and n % 2 == 0:
        out["S3"] = (["--ulysses_size", str(n // 2), "--ring_size", "2"],
                     "r1", None, NORM_TOL)
        out["S4"] = (["--ulysses_size", str(n // 2)], "r1", None, NORM_TOL)
    out["S5_int4"] = (fsdp + ["--quant", "int4"], "r1", "int4", "bit-equal")
    out["S5_w8a8"] = (fsdp + ["--quant", "w8a8"], "r1", "w8a8", "bit-equal")
    out["S7_ulysses"] = (fsdp, "c1", None, "bit-equal")
    out["S7_ring"] = (ring, "c1", None, NORM_TOL)
    out["S8"] = (fsdp, "i2v", None, "bit-equal")
    return out


def _expand(runs, n):
    """The mesh runs of ``--runs`` in order, S5 as its two quant modes and
    S7 as its two layouts; raises on a run that needs more ranks."""
    table = layouts(n)
    out = []
    for run in runs:
        if run in ("S0", "S6"):
            continue  # S0 is one card's; S6 rides on S1's pipeline
        names = {"S5": ["S5_int4", "S5_w8a8"],
                 "S7": ["S7_ulysses", "S7_ring"]}.get(run, [run])
        for name in names:
            if name not in table:
                raise SystemExit(f"{run} needs at least 4 ranks (an even "
                                 f"count); --ranks is {n}")
            out.append(name)
    if "S6" in runs and "S1" not in runs:
        raise SystemExit("S6 runs on S1's pipeline: add S1 to --runs")
    return out


def _records(runs, n) -> set:
    """The records a launch of ``runs`` must write."""
    return set(_expand(runs, n)) | ({"S0", "S6"} & set(runs)) | (
        {"S8_timed"} if "S8" in runs else set())


def _pairs_apart(args, request) -> bool:
    """Whether one card runs the request's CFG pair as two B = 1 forwards
    (``text2video.cfg_batched``; 1920×832×81 does), where a mesh always
    runs it as one B = 2 forward."""
    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.pipelines.text2video import (
        cfg_batched, compute_target_shape_and_seq_len)

    task, size, frames, _ = _request_args(args, request)
    config = WAN_CONFIGS[task]
    _, seq_len, _ = compute_target_shape_and_seq_len(config, size, frames)
    return not cfg_batched(config.model.dim, seq_len)


def _jobs(args, runs, names, table, world):
    """The one-card references the runs need, (request, quant, variant)
    each: ``served``, the request as one card serves it; ``batched``,
    where one card would run the CFG pair as two B = 1 forwards, the pair
    as one B = 2 forward, as the mesh runs it (the reference a mesh run is
    held to; the served one is recorded beside it); ``rolled``, S0's r1
    with its keys rolled; and the bf16 r1 served a second time where a
    rank is left for it."""
    jobs = []
    for name in names:
        request, quant = table[name][1:3]
        if request == "c1" and args.s7_unchecked:
            continue
        for variant in (("batched", "served") if _pairs_apart(args, request)
                        else ("served",)):
            if (request, quant, variant) not in jobs:
                jobs.append((request, quant, variant))
    if "S0" in runs:
        for job in (("r1", None, "served"), ("r1", None, "rolled")):
            if job not in jobs:
                jobs.append(job)
    if ("r1", None, "served") in jobs and world > len(jobs):
        jobs.append(("r1", None, "served"))
    return jobs


# ------------------------------------------------------------- the worker


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _size(text):
    return tuple(int(v) for v in text.split("*"))


def _request_args(args, request):
    """A request's (task, (W, H), frames, steps)."""
    if request == "c1":
        return (args.task, _size(args.s7_size), args.s7_frame_num,
                args.s7_steps)
    task = args.i2v_task if request == "i2v" else args.task
    return task, _size(args.size), args.frame_num, args.sample_steps


def _pipeline(task, device, quant=None, **kwargs):
    """``WanI2V`` for an i2v task, else ``WanT2V``."""
    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.pipelines.image2video import WanI2V
    from moviigen_tpu_torch.pipelines.text2video import WanT2V

    config = WAN_CONFIGS[task]
    cls = WanI2V if config.model.model_type == "i2v" else WanT2V
    return cls(config, device=device, quant=quant, **kwargs)


def _watch(pipe) -> dict:
    """From here on ``pipe`` shows what a request does beyond its output,
    in the dict returned (emptied at each call): the i2v conditioning
    (``clip_fea``, ``y``) it samples with, and ``pred``, the largest
    prediction of the DiT over the request's forwards, a device tensor (0
    with a zero head, whatever the blocks compute)."""
    import torch

    if not hasattr(pipe, "_tool_seen"):
        sample, head = pipe._sample, pipe.dit.head_output

        def sample_seen(*a, **cond):
            pipe._tool_seen.update(cond)
            return sample(*a, **cond)

        def head_seen(xr, e):
            out = head(xr, e)
            seen = pipe._tool_seen
            big = out.detach().abs().max()
            seen["pred"] = big if "pred" not in seen \
                else torch.maximum(seen["pred"], big)
            return out

        pipe._sample = sample_seen
        pipe.dit.head_output = head_seen
    pipe._tool_seen = {}
    return pipe._tool_seen


def _roll_keys(pipe):
    """S0: every self-attention of ``pipe``'s DiT runs over its keys and
    values rolled by half the sequence, the same attention with the keys
    in another order and other tiles."""
    from moviigen_tpu_torch.models.wan_model import WanModel
    from moviigen_tpu_torch.ops.attention import attention

    def rolled(q, k, v, k_lens):
        if k_lens is not None:
            raise ValueError("S0 rolls the keys of an unpadded sequence")
        half = k.shape[1] // 2
        return attention(q, k.roll(half, 1), v.roll(half, 1),
                         backend=pipe.attn_backend, compute_dtype=q.dtype)

    pipe.dit.run_blocks = functools.partial(WanModel.run_blocks, pipe.dit,
                                            self_attn_fn=rolled)


def _park_t5(pipe):
    """From here on ``pipe`` moves its T5 encoder to host memory once a
    request's prompts are encoded, before the denoise loop: the 1080p
    request's CFG pair as one B = 2 forward does not fit one card beside
    the 11 GB encoder (the first try ran out of memory at 65.6 GiB)."""
    import torch

    sample = pipe._sample

    def parked(*a, **cond):
        pipe.t5.to("cpu")
        if pipe.device.type == "cuda":
            torch.cuda.empty_cache()
        return sample(*a, **cond)

    pipe._sample = parked


class _TracedSteps(list):
    """A request's ``step_s`` list that traces denoise step
    ``PROFILE_STEP`` (``utils/profiling.trace``): the trace opens once the
    step before it is timed and closes once it is timed itself, so
    neither counts in a step's seconds. The ``Trace`` goes to ``done``."""

    def __init__(self, logdir, device, done):
        super().__init__()
        self._args, self._done = (logdir, device), done
        self._stack = contextlib.ExitStack()

    def append(self, seconds):
        from moviigen_tpu_torch.utils.profiling import trace

        super().append(seconds)
        if len(self) == PROFILE_STEP:
            self._done.append(self._stack.enter_context(trace(*self._args)))
        elif len(self) == PROFILE_STEP + 1:
            self._stack.close()


@contextlib.contextmanager
def _traced_step(pipe, logdir, device):
    """Within it ``pipe``'s requests trace their step ``PROFILE_STEP``;
    yields the list that gets each ``Trace``."""
    done = []
    sample = pipe._sample

    def traced(*a, **cond):
        pipe.timings["step_s"] = _TracedSteps(logdir, device, done)
        return sample(*a, **cond)

    pipe._sample = traced
    try:
        yield done
    finally:
        pipe._sample = sample


def _request(pipe, args, request, profile_dir=None):
    """A request through ``generate``: (latent [z, F', H', W'] numpy,
    video numpy on the output rank else None, the pipeline's timings,
    what ``_watch`` saw). With ``profile_dir``, its step
    ``PROFILE_STEP`` is traced there and ``seen["trace"]`` is the
    ``Trace``."""
    import torch
    from bench_torch import first_frame

    _, size, frames, steps = _request_args(args, request)
    image = (first_frame(size, args.seed),) if request == "i2v" else ()
    seen = _watch(pipe)
    with (_traced_step(pipe, profile_dir, pipe.device) if profile_dir
          else contextlib.nullcontext([])) as traces:
        latent = pipe.generate(PROMPT, *image, size=size, frame_num=frames,
                               sampling_steps=steps,
                               guide_scale=args.guide_scale, seed=args.seed,
                               return_latents=True)
    if traces:
        seen["trace"] = traces[0]
    video = pipe.decode_request(torch.from_numpy(latent)[None]
                                .to(pipe.device))
    return latent, video, dict(pipe.timings), seen


def _cond(seen):
    """The checksum of an i2v request's ``clip_fea`` and ``y`` (None for
    t2v)."""
    if "clip_fea" not in seen:
        return None
    return cards.checksum(seen["clip_fea"], seen["y"])


def _rel(got, want):
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return (float(np.linalg.norm(got - want) / np.linalg.norm(want)),
            float(np.abs(got - want).max()))


def _per_step(step_s):
    """The median step after the first (the first alone when there is one
    step)."""
    return statistics.median(step_s[1:] or step_s)


def _references(args, jobs, rank, world, device):
    """This rank's share of the one-card requests (``jobs``), each written
    to ``ref<i>.npz`` with its record."""
    import numpy as np

    from moviigen_tpu_torch.pipelines import text2video

    pairing = text2video.cfg_batched
    for i, (request, quant, variant) in enumerate(jobs):
        if i % world != rank:
            continue
        cards.reset_peak(device)
        t0 = time.perf_counter()
        pipe = _pipeline(_request_args(args, request)[0], device, quant)
        _sync(device)
        init_s = time.perf_counter() - t0
        init_peak = cards.peak_gib(device)
        cards.reset_peak(device)
        drawn = cards.checksum(pipe.t5, pipe.vae_params, pipe.dit).tolist()
        if variant == "rolled":
            _roll_keys(pipe)
        if variant == "batched":  # the mesh's CFG pairing
            text2video.cfg_batched = lambda *a: True
            _park_t5(pipe)
        try:
            latent, video, timings, seen = _request(pipe, args, request)
        finally:
            text2video.cfg_batched = pairing
        cond = _cond(seen)
        np.savez(OUT / f"ref{i}.npz", latent=latent, video=video)
        (OUT / f"ref{i}.json").write_text(json.dumps(dict(
            request=request, quant=quant, variant=variant, rank=rank,
            init_s=init_s, weights=drawn, step_s=timings["step_s"],
            t5_s=timings["t5_s"], decode_s=timings.get("decode_s"),
            clip_s=timings.get("clip_s"), encode_s=timings.get("encode_s"),
            cond=None if cond is None else cond.tolist(),
            pred_max_abs=float(seen["pred"]), init_peak_gib=init_peak,
            peak_gib=cards.peak_gib(device))))
        del pipe, seen
        cards.free(device)


def _gate(gate, rel, equal):
    return equal if gate == "bit-equal" else rel <= gate


def worker(argv):
    global OUT
    args = _parser().parse_args(argv)
    OUT = pathlib.Path(args.out_dir)
    import numpy as np
    import torch
    import torch.distributed as dist

    from moviigen_tpu_torch.cli import generate
    from moviigen_tpu_torch.models import clip as clipm
    from moviigen_tpu_torch.models import tokenizer
    from moviigen_tpu_torch.parallel import distributed
    from moviigen_tpu_torch.pipelines import text2video

    if not distributed.maybe_initialize_distributed(device=args.device):
        raise RuntimeError("no process group: launch the workers with "
                           "torchrun")
    rank, world = dist.get_rank(), dist.get_world_size()
    device = distributed.local_device(args.device)
    # random weights: the prompt's ids need only be the same everywhere
    tokenizer._huggingface_or_none = lambda **kwargs: None
    cards.draw_live_heads()
    if args.small_clip:
        clipm.CLIPVisionConfig = functools.partial(clipm.CLIPVisionConfig,
                                                   **SMALL_CLIP)
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
    jobs = _jobs(args, runs, names, table, world)
    ref_of = {job: jobs.index(job) for job in jobs}

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
    r1 = ref_of.get(("r1", None, "served"))
    twice = [i for i, job in enumerate(jobs)
             if job == ("r1", None, "served") and i != r1]
    same = None
    if twice:
        first, again = refs[r1], refs[twice[0]]
        same = (np.array_equal(again["latent"], first["latent"])
                and np.array_equal(again["video"], first["video"])
                and again["weights"] == first["weights"])
    # one card against itself with its CFG pair run the other way
    pairing = {f"{req} {q or 'bf16'}": _rel(
        refs[i]["latent"], refs[ref_of[(req, q, "served")]]["latent"])[0]
        for (req, q, variant), i in ref_of.items() if variant == "batched"}
    write(dict(run="one-card references",
               seconds=time.perf_counter() - t0,
               jobs=[list(map(str, job)) for job in jobs],
               ranks=[r["rank"] for r in refs],
               init_s=[r["init_s"] for r in refs],
               step_s=[r["step_s"] for r in refs],
               t5_s=[r["t5_s"] for r in refs],
               decode_s=[r["decode_s"] for r in refs],
               init_peak_gib=[r["init_peak_gib"] for r in refs],
               peak_gib=[r["peak_gib"] for r in refs],
               cfg_batched_vs_served_rel_err=pairing,
               bf16_on_two_cards_bit_equal=same))
    if same is False:
        raise RuntimeError(
            "the one-card bf16 request differs between rank "
            f"{refs[r1]['rank']}'s card and rank {refs[twice[0]]['rank']}'s")
    if "S0" in runs:
        rolled = refs[ref_of[("r1", None, "rolled")]]
        rel, max_abs = _rel(rolled["latent"], refs[r1]["latent"])
        write(dict(run="S0", request="r1", guide_scale=args.guide_scale,
                   keys="rolled by half the sequence in every "
                        "self-attention", rank=rolled["rank"],
                   latent_rel_err=rel, latent_max_abs_err=max_abs,
                   latent_bit_equal=bool(np.array_equal(
                       rolled["latent"], refs[r1]["latent"])),
                   video_rel_err=_rel(rolled["video"],
                                      refs[r1]["video"])[0],
                   step_s=rolled["step_s"], ref_step_s=refs[r1]["step_s"],
                   pred_max_abs=rolled["pred_max_abs"], ok=True))

    if args.profile:
        # after the one-card references: warmed before them, the 1080p
        # reference (CFG pair batched, 67.6 GiB) failed in its decode with
        # CUDNN_STATUS_INTERNAL_ERROR on an H100
        cards.warm_tracer(OUT, device)
    for name in names:
        flags, request, quant, gate = table[name]
        task = _request_args(args, request)[0]
        # the CLI's flags for the mesh and the weights; the request is
        # the tool's own (r1 is not in the CLI's size table at t2v-tiny),
        # its image too (the CLI asks only that i2v name one)
        image = ["--image", "drawn-from-seed"] if request == "i2v" else []
        gargs = generate._parse_args(
            ["--task", task, "--device", args.device, *flags, *image])
        generate._validate_args(gargs)
        cards.reset_peak(device)
        t0 = time.perf_counter()
        mesh, sp_mode = generate.build_mesh(gargs)
        streams = cards.comm_streams(mesh, device, OUT, rank) \
            if args.profile and mesh is not None \
            and torch.device(device).type == "cuda" else None
        pipe = _pipeline(task, device, quant,
                         residual_dtype=gargs.residual_dtype, mesh=mesh,
                         sp_mode=sp_mode)
        _sync(device)
        init_s = time.perf_counter() - t0
        init_peak = cards.peak_gib(device)
        cards.reset_peak(device)
        batched = (request, quant, "batched")
        weights = drawn.pop("weights")
        ref = served = None  # --s7_unchecked: S7 has no reference
        if (request, quant, "served") in ref_of:
            ref = refs[ref_of.get(batched,
                                  ref_of[(request, quant, "served")])]
            served = refs[ref_of[(request, quant, "served")]]
            if weights != ref["weights"]:
                raise RuntimeError(f"{name}: the mesh's weights are not "
                                   "the one-card reference's")
        cards.reset_launch_counts()
        latent, video, timings, seen = _request(
            pipe, args, request,
            OUT / "profile" / name / f"rank{rank}" if args.profile
            else None)
        launches = cards.launch_counts()
        if args.profile:
            cards.write_profile(OUT, name, rank, cards.profile_summary(
                seen["trace"], pipe.config.model.num_layers, streams)
                if "trace" in seen else None)
        rel = max_abs = equal = video_equal = video_rel = None
        if ref is not None:
            rel, max_abs = _rel(latent, ref["latent"])
            equal = bool(np.array_equal(latent, ref["latent"]))
            if video is not None:  # rank 0's
                video_equal = bool(np.array_equal(video, ref["video"]))
                video_rel = _rel(video, ref["video"])[0]
        cond = _cond(seen)
        cond_equal = None
        if cond is not None:
            cond_equal = cards.same_on_every_rank(
                cond, f"{name}: clip_fea and y") == ref["cond"]
        peaks = cards.gather_floats([init_peak, cards.peak_gib(device)],
                                    device)  # every rank's profile written
        # bit-equal latents decode to the same video bits
        ok = (_gate(gate, rel, equal) if ref is not None
              else bool(np.isfinite(latent).all()) and (
                  video is None or bool(np.isfinite(video).all())))
        ok = (ok and (gate != "bit-equal" or video_equal is not False)
              and cond_equal is not False)
        s_step = _per_step(timings["step_s"])
        tokens = int(np.prod(latent.shape[1:])) // 4
        record = dict(
            run=name, flags=flags, mesh=dict(mesh.shape), sp_mode=sp_mode,
            quant=quant or "bf16", task=task, request=request,
            tokens=tokens, guide_scale=args.guide_scale, init_s=init_s,
            t5_s=timings["t5_s"], step_s=timings["step_s"],
            s_per_step=s_step, mfu_per_card=_mfu(pipe, tokens, s_step),
            decode_s=timings.get("decode_s"), clip_s=timings.get("clip_s"),
            encode_s=timings.get("encode_s"),
            ref_variant=ref and ref["variant"],
            ref_step_s=ref and ref["step_s"], ref_rank=ref and ref["rank"],
            ref_peak_gib=ref and ref["peak_gib"],
            latent_rel_err=rel, latent_max_abs_err=max_abs,
            latent_bit_equal=equal, video_bit_equal=video_equal,
            video_rel_err=video_rel, cond_same_as_one_card=cond_equal,
            pred_max_abs=float(seen["pred"]),
            gate=gate if ref is not None else "finite (--s7_unchecked)",
            ok=bool(ok), launches=launches,
            init_peak_gib=[p[0] for p in peaks],
            peak_gib=[p[1] for p in peaks])
        if args.profile and rank == 0:
            record["profile"] = cards.read_profiles(OUT, name, world)
            if all(record["profile"]):
                record["nccl_waits"] = cards.waits_of(record["profile"])
        if served is not ref:  # against the request as one card serves it
            record.update(zip(("served_latent_rel_err",
                               "served_latent_max_abs_err"),
                              _rel(latent, served["latent"])),
                          served_step_s=served["step_s"],
                          served_peak_gib=served["peak_gib"])
        if video is not None and request == "c1":
            record["min_per_clip_50"] = (
                timings["t5_s"] + CLIP_STEPS * s_step
                + timings["decode_s"]) / 60
        write(record)
        if not ok:
            raise RuntimeError(f"{name}: gate {record['gate']} failed: "
                               f"latents {rel} of their norm off one card's "
                               f"(bit-equal {equal}, video {video_equal}, "
                               f"clip_fea and y {cond_equal})")
        if name == "S1" and "S6" in runs:
            _timed(pipe, args, init_s, device, write, "S6",
                   _size(args.s6_size), args.s6_frame_num)
        if name == "S8":
            _timed(pipe, args, init_s, device, write, "S8_timed",
                   _size(args.s8_size), args.s8_frame_num)
        del pipe, mesh, seen
        cards.free(device)
    dist.barrier()
    dist.destroy_process_group()


def _mfu(pipe, tokens, s_step):
    """The DiT's flops for the CFG pair over a step's seconds, a card's
    share of the bf16 peak (None on the CPU)."""
    from bench_torch import dit_flops

    if pipe.device.type != "cuda":
        return None
    world = pipe.mesh.size if pipe.mesh is not None else 1
    return dit_flops(pipe.config.model, tokens, batch=2) / s_step / world \
        / PEAK_BF16_FLOPS


def _timed(pipe, args, init_s, device, write, run, size, frames):
    """A long request on a run's pipeline, timed as ``bench_torch.py``
    times one: S6, ``scripts/inference.sh``'s on S1's; S8_timed, the i2v
    one on S8's, its ``clip_fea`` and ``y`` the same on every rank."""
    import numpy as np
    from bench_torch import first_frame

    from moviigen_tpu_torch.pipelines.text2video import (
        compute_target_shape_and_seq_len)

    i2v = pipe.config.model.model_type == "i2v"
    steps = args.s6_warmup + args.s6_timed
    _, tokens, _ = compute_target_shape_and_seq_len(pipe.config, size,
                                                    frames)
    cards.free(device)
    cards.reset_peak(device)
    cards.reset_launch_counts()
    seen = _watch(pipe)
    image = (first_frame(size, args.seed),) if i2v else ()
    video = pipe.generate(PROMPT, *image, size=size, frame_num=frames,
                          sampling_steps=steps, seed=args.seed)
    launches = cards.launch_counts()
    t = dict(pipe.timings)
    peaks = cards.gather_floats([cards.peak_gib(device)], device)
    s_step = statistics.median(t["step_s"][args.s6_warmup:])
    record = dict(run=run, task=pipe.config.name, size="*".join(
                      map(str, size)), frames=frames,
                  tokens=tokens, mesh=dict(pipe.mesh.shape),
                  cfg="batched (the mesh's rule)", init_s=init_s,
                  t5_s=t["t5_s"], step_s=t["step_s"], s_per_step=s_step,
                  mfu_per_card=_mfu(pipe, tokens, s_step),
                  peak_gib=[p[0] for p in peaks], launches=launches,
                  pred_max_abs=float(seen["pred"]))
    ok = True
    if i2v:
        record.update(clip_s=t["clip_s"], encode_s=t["encode_s"])
        cards.same_on_every_rank(_cond(seen), f"{run}: clip_fea and y")
    if video is not None:  # rank 0 decodes
        want = (3, frames, size[1], size[0])
        finite = bool(np.isfinite(video).all())
        ok = (video.shape == want and finite
              and float(video.min()) >= -1.0 and float(video.max()) <= 1.0)
        clip_steps = I2V_CLIP_STEPS if i2v else CLIP_STEPS
        record.update(decode_s=t["decode_s"], video_shape=list(video.shape),
                      video_finite=finite, video_min=float(video.min()),
                      video_max=float(video.max()),
                      video_std=float(video.std()), ok=ok)
        record[f"min_per_clip_{clip_steps}"] = (
            t["t5_s"] + t.get("clip_s", 0.0) + t.get("encode_s", 0.0)
            + clip_steps * s_step + t["decode_s"]) / 60
    write(record)
    if not ok:
        raise RuntimeError(f"{run}: the video fails its checks: {record}")


# --------------------------------------------------------------- the tool


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", default="t2v-14B")
    ap.add_argument("--i2v_task", default="i2v-14B", help="S8's task")
    ap.add_argument("--small_clip", action="store_true",
                    help="a two-block CLIP tower with the full one's "
                         "output, for i2v on the CPU")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=4,
                    help="ranks (one card each)")
    ap.add_argument("--runs", default=",".join(RUNS))
    ap.add_argument("--size", default="832*480", help="r1's W*H")
    ap.add_argument("--frame_num", type=int, default=17)
    ap.add_argument("--sample_steps", type=int, default=4)
    ap.add_argument("--guide_scale", type=float, default=5.0,
                    help="the CFG guide scale of r1, S7 and S8 (the "
                         "CLI's --sample_guide_scale)")
    ap.add_argument("--s6_size", default="1280*720")
    ap.add_argument("--s6_frame_num", type=int, default=81)
    ap.add_argument("--s6_warmup", type=int, default=1)
    ap.add_argument("--s6_timed", type=int, default=3)
    ap.add_argument("--s7_size", default="1920*832")
    ap.add_argument("--s7_frame_num", type=int, default=81)
    ap.add_argument("--s7_steps", type=int, default=2)
    ap.add_argument("--s8_size", default="1280*720")
    ap.add_argument("--s8_frame_num", type=int, default=81)
    ap.add_argument("--out_dir", default=str(OUT),
                    help="where the runs write (emptied first)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--s7_unchecked", action="store_true",
                    help="run S7 without its one-card references (about "
                         "three minutes of every card): its gate is then "
                         "a finite latent and video")
    ap.add_argument("--profile", action="store_true",
                    help="trace one denoise step of each mesh run on "
                         "every rank; records gain 'profile'")
    ap.add_argument("--timeout", type=float, default=3000.0,
                    help="seconds the launch may take")
    return ap


def main(argv=None):
    global OUT
    args = _parser().parse_args(argv)
    OUT = pathlib.Path(args.out_dir)
    runs = args.runs.split(",")
    want = _records(runs, args.ranks)  # refuses before launching
    import shutil

    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    if args.device != "cpu":
        # built once here, not by every rank at its first launch
        from moviigen_tpu_torch import kernels

        kernels.build(kernels.KERNELS)
    worker_args = [a for a in (argv if argv is not None else sys.argv[1:])]
    seconds = cards.launch(pathlib.Path(__file__).resolve(), worker_args,
                           args.ranks, OUT / "launch.log", args.timeout,
                           env=ALLOC_ENV)
    records = [json.loads(line) for line in
               (OUT / "records.jsonl").read_text().splitlines()]
    for record in records:
        print(json.dumps(record), flush=True)
    done = {r["run"] for r in records}
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
