#!/usr/bin/env python3
"""Sequence-parallel fine-tuning across cards: ``cli.finetune`` and the
SP train step under ``torchrun``, one rank per card over NCCL, held
against one card.

    python3 tools/sp_train_cards.py                        # 4 cards
    python3 tools/sp_train_cards.py --runs T2,T3           # some runs
    python3 tools/sp_train_cards.py --device cpu --task t2v-tiny \\
        --big_task t2v-tiny --ranks 2 --latent 4,2,8,8     # 2 gloo ranks

Writes a synthetic latent dataset (``--clips`` clips of ``--latent``
[C, F, H, W], random from ``--seed``; by default 480×832 at 21 latent
frames, 32,760 tokens: the CLI's defaults) under ``_smoke_out/sp_train``,
then runs each run of ``--runs`` (N = ``--ranks``), each launch one
``torchrun --standalone`` of N ranks (NCCL on cards, gloo with
``--device cpu``), the one-card launches plain processes:

- T1: ``finetune --task <big_task> --sp_size N --gradient_checkpointing``
  (full fine-tuning, fp32 master weights and AdamW), ``--steps`` steps
  and the final checkpoint; no one-card run holds it. Gate: losses and
  gradient norms finite. Reports s/step, every rank's peak GiB with the
  model and optimizer built (init), over the steps, and with the save,
  the save's seconds and GiB. The free disk is checked against the
  checkpoint's size first and reported;
- T2: one step of T1's model at library level (``make_train_step`` with
  a mesh), depth cut to ``--t2_layers`` blocks, Ulysses sp N, against
  the same step on one card (each rank runs it on its own card; after a
  warm-up, ``--timed_steps`` SP steps, their median kept); gate:
  loss bit-equal, every gradient within 2e-2 of its norm (a linear's
  weight and bias as one tensor);
- T3: the same for ``--task`` at full depth, ring sp N, then USP N/2 × 2;
  gate: loss within 5e-3, gradients within 2e-2 of their norm;
- T4: ``finetune --task <task> --sp_size N/2`` over N ranks (data 2 ×
  seq N/2, 2 items a micro-step) with ``--gradient_accumulation_steps
  2``, against one card with ``--train_batch_size 2`` and the same
  accumulation: the same items and noise; gate: losses within 5e-3;
- T5: ``finetune --task <task> --sp_size N``: ``--steps`` steps with a
  checkpoint at ``--steps - 1``, then a new launch resumed from it for the
  last step; gate: the last step's loss, and the final checkpoint's
  weights and optimizer state, bit-equal to the run without a stop.

With ``--profile``, T2 and T3 trace one more SP step of each mode after
the timed one on every rank (``utils/profiling.trace``; Chrome traces
under ``<out_dir>/profile``), and the record gains ``profile``, each
rank's ``cards.profile_summary``: device ms of compute and of NCCL, NCCL
ms under compute, exposed NCCL ms (in all, per block, by NCCL kernel),
the idle share, and NCCL's kernels by group (``cards.comm_streams``: the
axis' own group on the caller's stream, the shifts') and op; and ``nccl_waits``, every op lined up across its
group's ranks (``cards.nccl_waits``): each rank's wait for the last one
to arrive, and what that one ran before it. Every record holds each
rank's caching-allocator counters over the timed step
(``cards.allocator_stats``: retries, ``cudaMalloc`` calls).

Every rank of a launch checks that the weights it drew from the seed are
every other rank's before it cuts its shards. One JSON line per run (the
per-step seconds and their median over steps 2 and on, losses, grad
norms, peak GiB per rank, errors against one card, launches); then
every card's name and power limit as ``nvidia-smi`` prints them. Fails
(non-zero exit) if a launch, a rank, a check or a gate fails; a failed
run ends the tool, and no later run is tried.
"""

import argparse
import filecmp
import json
import os
import pathlib
import shutil
import statistics
import sys
import time
import types

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from tools import cards  # noqa: E402

ROOT = cards.ROOT
OUT = ROOT / "_smoke_out" / "sp_train"  # --out_dir
RUNS = ("T1", "T2", "T3", "T5", "T4")
GRAD_REL_TOL = 2e-2  # bf16 compute summed in another order (PR 14's gate)
LOSS_REL_TOL = 5e-3


def _dataset(latent, clips, text_dim, seed):
    """A latent set in the reference layout; returns its json."""
    data = OUT / "data"
    for d in (data / "latent", data / "prompt_embed"):
        d.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    annos = []
    for i in range(clips):
        np.save(data / "latent" / f"clip{i}.npy",
                rng.standard_normal(latent, dtype=np.float32))
        np.save(data / "prompt_embed" / f"clip{i}.npy",
                rng.standard_normal((77, text_dim), dtype=np.float32))
        annos.append({"latent_path": f"clip{i}.npy",
                      "prompt_embed_path": f"clip{i}.npy",
                      "length": 4 * (latent[1] - 1) + 1,
                      "aspect_ratio_bin": 0})
    path = data / "videos2caption.json"
    path.write_text(json.dumps(annos))
    return path


def _median_after_first(xs):
    return statistics.median(xs[1:]) if len(xs) > 1 else xs[0]


# ------------------------------------------------- worker: cli.finetune


def worker_finetune(argv):
    """One rank of a ``cli.finetune`` launch (or the one-card process):
    ``finetune.main(argv)``, which brings the process group up from
    torchrun's variables and down again. The random DiT's head is drawn
    (``cards.draw_live_heads``). Before the DiT is cut into shards, every
    rank's checksum of it must be every other rank's. Each
    rank writes ``$SP_CARDS_OUT.rank<r>``: its peak GiB with the model and
    optimizer built, after each step, and at the end (the final save's);
    rank 0 also writes the run's record to ``$SP_CARDS_OUT``."""
    import torch

    from moviigen_tpu_torch import training
    from moviigen_tpu_torch.cli import finetune
    from moviigen_tpu_torch.parallel import distributed, sharding

    rank = int(os.environ.get("RANK", "0"))
    out = pathlib.Path(os.environ["SP_CARDS_OUT"])
    mine = pathlib.Path(f"{out}.rank{rank}")
    progress = {"step_peak_gib": [], "step_s": []}
    device = {}
    shard, make_step = sharding.shard_params, training.make_train_step

    def checked_shard(module, spec, comm, axis):
        progress["weights"] = cards.same_on_every_rank(
            cards.checksum(module), "the DiT")
        return shard(module, spec, comm, axis)

    def recorded_step(model, *args, **kwargs):
        dev = next(model.parameters()).device
        device["dev"] = dev
        progress["init_peak_gib"] = cards.peak_gib(dev)
        cards.reset_peak(dev)  # the steps' own peak from here
        step = make_step(model, *args, **kwargs)

        def timed(batch, *a, **k):
            t0 = time.perf_counter()
            metrics = step(batch, *a, **k)
            loss = float(metrics["loss"])  # the CLI's own sync point
            progress["step_s"].append(time.perf_counter() - t0)
            progress["step_peak_gib"].append(cards.peak_gib(dev))
            progress.setdefault("loss", []).append(loss)
            progress.setdefault("grad_norm", []).append(
                float(metrics["grad_norm"]))
            mine.write_text(json.dumps(progress))
            return metrics

        return timed

    sharding.shard_params = checked_shard
    training.make_train_step = recorded_step
    cards.draw_live_heads()
    # no run here reads TensorBoard's logs (its import is seconds)
    sys.modules["torch.utils.tensorboard"] = None
    t0 = time.perf_counter()
    record = finetune.main(argv)
    main_s = time.perf_counter() - t0
    progress["final_peak_gib"] = cards.peak_gib(device["dev"])
    mine.write_text(json.dumps(progress))
    if rank == 0:
        path = pathlib.Path(record["checkpoint"])
        counts = cards.launch_counts()
        out.write_text(json.dumps(dict(
            step_s=record["step_s"], loss=record["loss"],
            grad_norm=record["grad_norm"], main_s=main_s,
            mesh=None if record["comm"] is None
            else dict(record["comm"].shape),
            weights=progress.get("weights"), launches=counts,
            checkpoint=str(path),
            checkpoint_save_s=record["checkpoint_s"],
            checkpoint_gib=sum(f.stat().st_size for f in path.iterdir())
            / 2**30)))
    del record
    if distributed.is_initialized():
        torch.distributed.destroy_process_group()


# ---------------------------------------- worker: the SP step, library


class _GradsOf:
    """An optimizer stand-in for ``make_train_step``: keeps the gradients
    by name, updates nothing; clips by ``make_optimizer``'s norm."""

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


def _groups(names):
    """A linear's weight and bias as one group under the linear's name;
    every other tensor alone."""
    groups = {}
    for name in names:
        owner, _, leaf = name.rpartition(".")
        if leaf in ("weight", "bias") and f"{owner}.weight" in names \
                and f"{owner}.bias" in names:
            groups.setdefault(owner, []).append(name)
        else:
            groups[name] = [name]
    return groups


def _grad_errors(comm, got, want, dims, axis):
    """Norm-relative errors of this rank's gradients against the one-card
    ones, per group (``_groups``) and per tensor: a shard's squared error
    summed over the shard axis (so over the whole tensor), a replicated
    tensor's this rank's own."""
    import torch

    names = sorted(want)
    n, i = comm.axis_size(axis), comm.axis_index(axis)
    err2, ref2 = [], []
    for name in names:
        w = want[name].float()
        if name in dims:
            c = w.shape[dims[name]] // n
            w_part = w.narrow(dims[name], i * c, c)
            e = (got[name].float() - w_part).square().sum()
        else:
            e = (got[name].float() - w).square().sum() / n
        err2.append(e)
        ref2.append(w.square().sum())
    err2 = comm.all_reduce(torch.stack(err2), axis)  # whole tensors
    ref2 = torch.stack(ref2)
    alone = {name: float((err2[k] / ref2[k].clamp_min(1e-30)).sqrt())
             for k, name in enumerate(names)}
    place = {name: k for k, name in enumerate(names)}
    grouped = {}
    for key, parts in _groups(names).items():
        e = sum(float(err2[place[p]]) for p in parts)
        r = sum(float(ref2[place[p]]) for p in parts)
        grouped[key] = (e / max(r, 1e-30)) ** 0.5
    return grouped, alone


def _expected_launches(mode, ring, sp, layers):
    """The launches that one SP train step with per-block remat makes on
    one rank (those it makes at all): the cross-attention's stats forward
    (again in the recompute), dKV and dQ, and the self-attention's: the
    same over N/sp heads (ulysses), or per key shard around the ring the
    carried forward (again in the recompute), dKV and dQ (ring: sp
    shards, usp: R)."""
    shards = {"ulysses": 0, "ring": sp, "usp": ring}[mode]
    counts = dict(stats_launches=layers * (2 + 2 * (mode == "ulysses")),
                  carry_launches=layers * 2 * shards,
                  dkv_launches=layers * (1 + max(shards, 1)),
                  dq_launches=layers * (1 + max(shards, 1)))
    return {k: v for k, v in counts.items() if v}


def _library_run(args, ref, mode, ring, seq, comm, streams, device, out):
    """One SP step of ``mode``: a warm-up, the timed steps (launches,
    allocator counters, peaks), the gradients against the one-card
    step's (``ref``: the run's model, inputs and one-card results), and
    with ``--profile`` one more step traced; rank 0 appends the record.
    Raises when a gate fails."""
    import torch
    import torch.distributed as dist

    from moviigen_tpu_torch.ops import flash_attention as fa
    from moviigen_tpu_torch.parallel import sharding
    from moviigen_tpu_torch.training import make_train_step

    cuda = torch.device(device).type == "cuda"
    rank, world = dist.get_rank(), dist.get_world_size()
    run, cfg, batch, noise, u = ref.run, ref.cfg, ref.batch, ref.noise, ref.u
    axis = sharding.shard_axis(comm)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    m = sharding.shard_params(ref.model, sharding.dit_param_specs(ref.model),
                              comm, axis)
    cap = _GradsOf(dict(m.named_parameters()), comm)
    step = make_train_step(m, ref.tc, ref.rope, cap, comm=comm, sp_mode=mode)
    step(batch, noise=noise, u=u)  # warm-up
    sync()
    cards.reset_peak(device)
    fa.reset_launch_counts()
    alloc0 = cards.allocator_stats(device)
    step_s = []
    for n in range(args.timed_steps):
        t0 = time.perf_counter()
        metrics = step(batch, noise=noise, u=u)
        sync()
        step_s.append(time.perf_counter() - t0)
        if n == 0:  # the first timed step's launches and allocations
            alloc = {k: v - alloc0[k] if k != "reserved_gib" else v
                     for k, v in cards.allocator_stats(device).items()}
            counts = {k: v for k, v in fa.launch_counts().items() if v}
    secs = statistics.median(step_s)
    expected = _expected_launches(mode, ring, ring * seq,
                                  cfg.num_layers) if cuda else {}
    dims = sharding.sharded_tensors(m)
    errs, alone = _grad_errors(comm, cap.grads, ref.want, dims, axis)
    peaks = cards.gather_floats([cards.peak_gib(device), ref.one_peak],
                                device)
    loss, one_loss = float(metrics["loss"]), float(ref.want_m["loss"])
    loss_rel = abs(loss - one_loss) / abs(one_loss)
    worst = sorted(errs.items(), key=lambda kv: -kv[1])
    loss_ok = loss == one_loss if ref.loss_gate == "bit-equal" \
        else loss_rel <= ref.loss_gate
    # the launches are the kernels' (the CPU runs the plain twins)
    ok = loss_ok and worst[0][1] <= GRAD_REL_TOL \
        and (not cuda or counts == expected)
    record = dict(
        run=run, task=ref.task, layers=cfg.num_layers, sp_mode=mode,
        mesh=dict(comm.shape),
        tokens=int(np.prod(ref.grid)), s=secs, step_s=step_s,
        one_card_s=ref.one_s,
        loss=loss, one_card_loss=one_loss, loss_rel_err=loss_rel,
        loss_bit_equal=loss == one_loss, loss_gate=ref.loss_gate,
        grad_norm=float(metrics["grad_norm"]),
        one_card_grad_norm=float(ref.want_m["grad_norm"]),
        tensors=len(errs), max_grad_rel_err=worst[0][1],
        worst=dict(worst[:4]),
        median_grad_rel_err=statistics.median(errs.values()),
        worst_alone=dict(sorted(alone.items(), key=lambda kv: -kv[1])[:4]),
        grad_gate=GRAD_REL_TOL, launches=counts, expected_launches=expected,
        peak_gib=[p[0] for p in peaks],
        one_card_peak_gib=[p[1] for p in peaks], weights=ref.weights,
        allocator=[dict(zip(alloc, row)) for row in cards.gather_floats(
            list(alloc.values()), device)] if alloc else [],
        sharded_tensors=len(dims), ok=bool(ok))
    if args.profile:
        from moviigen_tpu_torch.utils.profiling import trace

        name = f"{run}_{mode}"
        with trace(out.parent / "profile" / f"{name}_rank{rank}",
                   device) as tr:
            step(batch, noise=noise, u=u)
        cards.write_profile(out.parent, name, rank, cards.profile_summary(
            tr, cfg.num_layers, streams))
        dist.barrier()
        if rank == 0:
            record["profile"] = cards.read_profiles(out.parent, name, world)
            record["nccl_waits"] = cards.waits_of(record["profile"])
    if rank == 0:
        with open(out, "a") as fh:
            fh.write(json.dumps(record) + "\n")
    if not ok:
        raise RuntimeError(f"{run} {mode}: gate failed: {record}")


def worker_library(argv):
    """T2 and T3: for each model, the one-card step on this rank's card,
    then the SP step over a mesh of the whole world per mode, the
    gradients held against the one-card step's."""
    import torch
    import torch.distributed as dist

    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.models.wan_model import WanModel
    from moviigen_tpu_torch.ops.rope import rope_3d_freqs
    from moviigen_tpu_torch.parallel import distributed
    from moviigen_tpu_torch.parallel.mesh import make_mesh
    from moviigen_tpu_torch.training import TrainConfig, make_train_step

    args = _parser().parse_args(argv)
    if not distributed.maybe_initialize_distributed(device=args.device):
        raise RuntimeError("no process group: launch with torchrun")
    rank, world = dist.get_rank(), dist.get_world_size()
    device = distributed.local_device(args.device)
    cuda = torch.device(device).type == "cuda"
    latent = tuple(int(x) for x in args.latent.split(","))
    tc = TrainConfig(remat=True)
    out = pathlib.Path(os.environ["SP_CARDS_OUT"])

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    cards.draw_live_heads()
    if args.profile:
        cards.warm_tracer(out.parent, device)
    for run in args.runs.split(","):
        if run == "T2":
            task, layers = args.big_task, args.t2_layers
            modes = [("ulysses", 1, world)]
            loss_gate = "bit-equal"
        else:
            task, layers = args.task, None
            modes = [("ring", 1, world), ("usp", 2, world // 2)]
            loss_gate = LOSS_REL_TOL
        cfg = WAN_CONFIGS[task].model
        if layers:
            cfg = cfg.replace(num_layers=layers)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        model = WanModel(cfg, dtype=torch.float32, device=device)
        model.init_weights(gen)
        weights = cards.same_on_every_rank(cards.checksum(model), task)
        _, f, h, w = latent
        grid = (f // cfg.patch_size[0], h // cfg.patch_size[1],
                w // cfg.patch_size[2])
        rope = rope_3d_freqs(grid, cfg.head_dim, device=device)
        batch = {"latents": torch.randn(1, *latent, generator=gen,
                                        device=device),
                 "context": torch.randn(1, cfg.text_len, cfg.text_dim,
                                        generator=gen, device=device)}
        batch["context"][:, 77:] = 0.0  # a 77-token prompt
        noise = torch.randn(batch["latents"].shape, generator=gen,
                            device=device)
        u = torch.tensor([0.37], device=device)
        one = _GradsOf(dict(model.named_parameters()))
        one_step = make_train_step(model, tc, rope, one)
        if cuda:  # a warm-up, so that the one-card time is a step's
            one_step(batch, noise=noise, u=u)
            sync()
        cards.reset_peak(device)
        t0 = time.perf_counter()
        want_m = one_step(batch, noise=noise, u=u)
        sync()
        one_s = time.perf_counter() - t0
        one_peak = cards.peak_gib(device)
        want = one.grads
        zero = [n for n, g in want.items() if not bool(g.abs().max() > 0)]
        if zero:
            raise RuntimeError(f"{run}: all-zero one-card gradients "
                               f"{zero[:4]}")
        ref = types.SimpleNamespace(
            run=run, task=task, cfg=cfg, model=model, rope=rope,
            batch=batch, noise=noise, u=u, tc=tc, one_s=one_s,
            one_peak=one_peak, want=want, want_m=want_m,
            loss_gate=loss_gate, weights=weights, grid=grid)
        for mode, ring, seq in modes:
            mesh = make_mesh(data=1, ring=ring, seq=seq)
            streams = cards.comm_streams(mesh, device, out.parent, rank) \
                if args.profile and cuda else None
            _library_run(args, ref, mode, ring, seq, mesh, streams, device,
                         out)
            cards.free(device)
        del model, one, one_step, want, want_m, ref
        cards.free(device)
    dist.barrier()
    dist.destroy_process_group()


# --------------------------------------------------------------- the tool


def _finetune_launch(args, name, ranks, extra, env=None):
    """A ``cli.finetune`` launch (``ranks`` 0: a plain process on one
    card): rank 0's record, with every rank's peaks and step times."""
    out = OUT / f"{name}.json"
    argv = ["--finetune", "--device", args.device,
            "--data_json_path", args.data_json,
            "--num_latent_t", str(args.latent_t),
            "--gradient_checkpointing", "--seed", str(args.seed),
            *map(str, extra)]
    env = dict(env or {}, SP_CARDS_OUT=str(out))
    t0 = time.perf_counter()
    try:
        if ranks == 0:
            _plain(argv, env, OUT / f"{name}.log", args.timeout)
        else:
            cards.launch(pathlib.Path(__file__).resolve(), argv, ranks,
                         OUT / f"{name}.log", args.timeout, env=env)
    except SystemExit:
        for r in range(max(ranks, 1)):  # what the ranks got to
            path = pathlib.Path(f"{out}.rank{r}")
            if path.exists():
                print(json.dumps({"run": name, "rank": r, "progress":
                                  json.loads(path.read_text())}),
                      flush=True)
        raise
    row = json.loads(out.read_text())
    per_rank = [json.loads(pathlib.Path(f"{out}.rank{r}").read_text())
                for r in range(max(ranks, 1))]
    row.update(launch_s=time.perf_counter() - t0, ranks=max(ranks, 1),
               step_s_median=_median_after_first(row["step_s"]),
               init_peak_gib=[p.get("init_peak_gib") for p in per_rank],
               step_peak_gib=[max(p["step_peak_gib"]) for p in per_rank],
               final_peak_gib=[p["final_peak_gib"] for p in per_rank])
    return row


def _plain(argv, env, log_path, timeout):
    import subprocess

    with open(log_path, "w") as log:
        proc = subprocess.run(
            [sys.executable, __file__, "--worker", *argv], cwd=ROOT,
            env=dict(os.environ, **cards.STRICT_ENV, **env), stdout=log,
            stderr=subprocess.STDOUT, timeout=timeout)
    if proc.returncode != 0:
        print(log_path.read_text(errors="replace")[-12000:],
              file=sys.stderr)
        raise SystemExit(f"one-card process failed: {proc.returncode}; "
                         f"log {log_path}")


def _finite(row):
    return bool(np.isfinite(row["loss"]).all()
                and np.isfinite(row["grad_norm"]).all())


def run_t1(args):
    """Full fine-tuning of ``--big_task`` over N ranks, the final save
    included (the disk's room for it reported first)."""
    import torch

    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.models.wan_model import WanModel

    with torch.device("meta"):
        params = sum(p.numel() for p in WanModel(
            WAN_CONFIGS[args.big_task].model).parameters())
    need = 3 * 4 * params / 2**30  # fp32 weights and two moments
    free = shutil.disk_usage(OUT).free / 2**30
    print(json.dumps({"run": "T1", "parameters": params,
                      "checkpoint_gib": need, "disk_free_gib": free,
                      "disk_holds_it": free > need * 1.02}), flush=True)
    row = _finetune_launch(args, "T1", args.ranks, [
        "--task", args.big_task, "--sp_size", args.ranks,
        "--max_train_steps", args.steps, "--checkpointing_steps", 100000,
        "--output_dir", OUT / "T1"])
    row.update(run="T1", task=args.big_task, parameters=params,
               ok=_finite(row))
    shutil.rmtree(OUT / "T1", ignore_errors=True)
    return [row]


def run_t4(args):
    """data 2 × seq N/2 with accumulation against one card."""
    common = ["--task", args.task, "--gradient_accumulation_steps", 2,
              "--max_train_steps", 2 * 2, "--checkpointing_steps", 100000]
    mesh = _finetune_launch(args, "T4", args.ranks, common + [
        "--sp_size", args.ranks // 2, "--output_dir", OUT / "T4"])
    one = _finetune_launch(args, "T4_one", 0, common + [
        "--train_batch_size", 2, "--output_dir", OUT / "T4_one"])
    rel = (np.abs(np.asarray(mesh["loss"]) - np.asarray(one["loss"]))
           / np.abs(np.asarray(one["loss"]))).tolist()
    mesh.update(run="T4", task=args.task, one_card_loss=one["loss"],
                one_card_step_s=one["step_s"],
                one_card_peak_gib=one["step_peak_gib"], loss_rel_err=rel,
                loss_gate=LOSS_REL_TOL,
                ok=_finite(mesh) and max(rel) <= LOSS_REL_TOL)
    for name in ("T4", "T4_one"):
        shutil.rmtree(OUT / name, ignore_errors=True)
    return [mesh]


def run_t5(args):
    """A stop and a resume against the run without one."""
    steps = args.steps
    common = ["--task", args.task, "--sp_size", args.ranks,
              "--max_train_steps", steps]
    whole = _finetune_launch(args, "T5", args.ranks, common + [
        "--checkpointing_steps", steps - 1, "--output_dir", OUT / "T5"])
    resumed = _finetune_launch(args, "T5_resumed", args.ranks, common + [
        "--checkpointing_steps", 100000, "--output_dir", OUT / "T5_resumed",
        "--resume_from_checkpoint",
        OUT / "T5" / f"checkpoint-step_{steps - 1}"])
    same = {}
    for file in ("params.safetensors", "opt_state.safetensors"):
        same[file] = filecmp.cmp(
            OUT / "T5" / f"checkpoint-step_{steps}" / file,
            OUT / "T5_resumed" / f"checkpoint-step_{steps}" / file,
            shallow=False)
    row = dict(run="T5", task=args.task, mesh=whole["mesh"],
               loss=whole["loss"], resumed_loss=resumed["loss"],
               last_loss_bit_equal=resumed["loss"] == whole["loss"][-1:],
               checkpoint_bit_equal=same, step_s=whole["step_s"],
               resumed_step_s=resumed["step_s"],
               checkpoint_save_s=whole["checkpoint_save_s"],
               checkpoint_gib=whole["checkpoint_gib"],
               peak_gib=whole["final_peak_gib"],
               launch_s=[whole["launch_s"], resumed["launch_s"]])
    row["ok"] = row["last_loss_bit_equal"] and all(same.values())
    for name in ("T5", "T5_resumed"):
        shutil.rmtree(OUT / name, ignore_errors=True)
    return [row]


def run_library(args, runs):
    """T2 and T3 in one launch."""
    out = OUT / "library.jsonl"
    argv = ["--library", "--task", args.task, "--big_task", args.big_task,
            "--device", args.device, "--ranks", args.ranks, "--runs",
            ",".join(runs), "--latent", args.latent, "--t2_layers",
            args.t2_layers, "--seed", args.seed,
            "--timed_steps", args.timed_steps] \
        + (["--profile"] if args.profile else [])
    cards.launch(pathlib.Path(__file__).resolve(), argv, args.ranks,
                 OUT / "library.log", args.timeout,
                 env={"SP_CARDS_OUT": str(out)})
    return [json.loads(line) for line in out.read_text().splitlines()]


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", default="t2v-1.3B",
                    help="the model of T3, T4 and T5")
    ap.add_argument("--big_task", default="t2v-14B",
                    help="the model of T1 and T2")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=4,
                    help="ranks (one card each)")
    ap.add_argument("--runs", default=",".join(RUNS))
    ap.add_argument("--latent", default="16,21,60,104",
                    help="C,F,H,W of each clip (default: 32,760 tokens)")
    ap.add_argument("--clips", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--t2_layers", type=int, default=4)
    ap.add_argument("--out_dir", default=str(OUT),
                    help="where the runs write (emptied first)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="T2, T3: trace one more step of each mode on "
                         "every rank; records gain 'profile'")
    ap.add_argument("--timed_steps", type=int, default=1,
                    help="T2, T3: SP steps timed after the warm-up (the "
                         "record's s is their median)")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds a launch may take")
    return ap


def main():
    global OUT
    args = _parser().parse_args()
    OUT = pathlib.Path(args.out_dir)
    runs = args.runs.split(",")
    unknown = set(runs) - set(RUNS)
    if unknown:
        raise SystemExit(f"unknown runs {sorted(unknown)}")
    if {"T3", "T4"} & set(runs) and (args.ranks < 2 or args.ranks % 2):
        raise SystemExit("T3 and T4 cut the ranks in two: --ranks must be "
                         "even")

    latent = tuple(int(x) for x in args.latent.split(","))
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    if args.device != "cpu":
        from moviigen_tpu_torch import kernels

        kernels.build(kernels.KERNELS)  # once, not by every rank
    if {"T1", "T4", "T5"} & set(runs):  # the CLI's runs read a dataset
        from moviigen_tpu_torch.configs import WAN_CONFIGS

        args.data_json = str(_dataset(
            latent, args.clips, WAN_CONFIGS[args.task].model.text_dim,
            args.seed))
        args.latent_t = latent[1]
    rows = []
    try:
        done_library = False
        for run in runs:
            if run in ("T2", "T3"):
                if done_library:
                    continue
                done_library = True
                new = run_library(args, [r for r in runs
                                         if r in ("T2", "T3")])
            else:
                new = {"T1": run_t1, "T4": run_t4, "T5": run_t5}[run](args)
            for row in new:
                print(json.dumps(row), flush=True)
                if not row.get("ok"):
                    raise SystemExit(f"{row['run']}: gate failed")
            rows += new
    finally:
        shutil.rmtree(OUT / "data", ignore_errors=True)
    if args.device != "cpu":
        for line in cards.card_lines():
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    if "--worker" in sys.argv:
        argv = [a for a in sys.argv[1:] if a != "--worker"]
        if argv[0] == "--library":
            worker_library(argv[1:])
        else:
            worker_finetune(argv[1:])
    else:
        sys.exit(main())
