#!/usr/bin/env python3
"""The ring's K/V shift beside its carried forward kernel, on several
cards over NCCL: whether a shift on the communication stream runs under
the kernel, and how many SMs the kernel must leave free for it.

    python3 tools/ring_overlap_probe.py                  # 4 cards
    python3 tools/ring_overlap_probe.py --shapes 2x2048x40 --spare 8

One ``torchrun`` launch of ``--ranks`` ranks, a ring over all of them
(``make_mesh(seq=ranks)``). For each shape B x L x N (head dim 128, bf16;
default S7's ring shard, 2 x 32,768 x 40, and S2's, 2 x 2,048 x 40) every
rank times, host clock around a synchronized window that starts at a
barrier, median of ``--reps``:

- ``kernel``: one middle step of the ring (``flash_attention_carry`` from
  a carried state) at the full grid, and at ``sms - k`` blocks for each k
  of ``--spare`` (``spare_sms``); each reduced grid's state must be the
  full grid's bit for bit, or the probe fails;
- ``shift``: K and V shifted one rank down (``Comm.ring_shift_start``),
  waited for;
- ``chain`` at each grid: the ring's pattern, a shift started, the kernel
  launched, then the next shift chained on the first (it becomes ready
  while the kernel runs); with a full grid NCCL's kernel cannot be
  resident until the step ends;
- ``chain`` traced (``utils/profiling.trace``) at the full grid and at the
  largest spare: ``cards.profile_summary`` and the grid NCCL's kernels
  launched with (from the Chrome trace).

With ``--train`` it runs the ring as a training step runs it instead:
for each shape of ``--train_shapes`` (default T3's ring shard, 1 x
8,192 x 12) one ring forward and backward under autograd, in the
program's schedule (``synchronous``: ``RingAttention``, its shifts on the
compute stream) and in a candidate (``overlapped``: ``OverlappedRing``,
each shift started before the kernels it must not wait for, the
accumulators' after their add, as XLA orders the JAX ring's; on four
H100s it slowed the 1.3B's step, so the program does not run it). Out,
dq, dk and dv must be the same bits in both, or the probe fails; each is
timed as above and traced once, with NCCL's kernels split by group and
op and lined up across the ranks (``cards.comm_streams``,
``cards.nccl_waits``).

Prints one JSON line per case (every rank's ms), then the cards' names
and power limits. Fails on a rank's error or a grid that changes a bit.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from moviigen_tpu_torch.parallel import ring  # noqa: E402
from moviigen_tpu_torch.parallel.comm import ready  # noqa: E402
from tools import cards  # noqa: E402

OUT = cards.ROOT / "_smoke_out" / "ring_overlap"


class OverlappedRing(torch.autograd.Function):
    """``ring.RingAttention`` with its shifts overlapped under autograd
    too: the forward starts each shift before its step's kernels (the
    serving schedule), and the backward starts step s + 1's K/V shift
    before step s's pair and each accumulator's shift once the pair's
    share is added to it (``moviigen_tpu/parallel/ring.py:196-210``).
    The same sums in the same order: out, dq, dk and dv are
    ``RingAttention``'s bit for bit."""

    @staticmethod
    def forward(ctx, q, k, v, k_lens, comm, axis, scale, backend):
        out, m, l = ring._ring_fwd_loop(q, k, v, k_lens, comm, axis, scale,
                                        backend, overlap=True)
        ctx.save_for_backward(q, k, v, out, m, l, k_lens)
        ctx.args = (comm, axis, scale, backend)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, m, l, k_lens = ctx.saved_tensors
        comm, axis, scale, backend = ctx.args
        sp, me = comm.axis_size(axis), comm.axis_index(axis)
        shard = k.shape[1]
        do = g.to(q.dtype)
        bwd = ring.flash_bwd_cuda if q.is_cuda and backend == "auto" \
            else ring.flash_bwd_plain
        dq, dk, dv = (torch.zeros(t.shape, dtype=torch.float32,
                                  device=q.device) for t in (q, k, v))
        blk = (k, v)  # the held K/V: tensors or shifts in flight
        for step in range(sp):
            src = (me - step) % sp
            held = blk
            if step < sp - 1:  # the next pair's K/V, under this pair
                blk = tuple(comm.ring_shift_start(x, axis) for x in blk)
            k_blk, v_blk = (ready(x) for x in held)
            dq_p, dk_p, dv_p = bwd(q, k_blk, v_blk,
                                   ring._local_klens(k_lens, src, shard),
                                   out, m, l, do, scale)
            dq += dq_p.float()
            dk, dv = ready(dk), ready(dv)
            dk += dk_p.float()
            dv += dv_p.float()
            dk = comm.ring_shift_start(dk, axis)
            dv = comm.ring_shift_start(dv, axis)
        return (dq.to(q.dtype), ready(dk).to(k.dtype),
                ready(dv).to(v.dtype), None, None, None, None, None)


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--shapes", default="2x32768x40,2x2048x40",
                    help="B x L x N of a ring shard, comma-separated")
    ap.add_argument("--spare", default="4,8,16",
                    help="SMs the kernel leaves free, comma-separated")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--train", action="store_true",
                    help="the training ring, forward and backward, in "
                         "both schedules")
    ap.add_argument("--train_shapes", default="1x8192x12",
                    help="B x L x N of a ring shard, comma-separated")
    ap.add_argument("--timeout", type=float, default=600.0)
    return ap


def worker(argv):
    import torch.distributed as dist

    from moviigen_tpu_torch.ops.flash_attention import (CarryState,
                                                        flash_attention_carry)
    from moviigen_tpu_torch.parallel import distributed
    from moviigen_tpu_torch.parallel.mesh import make_mesh
    from moviigen_tpu_torch.utils.profiling import trace

    args = _parser().parse_args(argv)
    if not distributed.maybe_initialize_distributed(device="cuda"):
        raise RuntimeError("launch with torchrun")
    rank, world = dist.get_rank(), dist.get_world_size()
    device = torch.device(distributed.local_device("cuda"))

    def sync():
        torch.cuda.synchronize(device)
    comm = make_mesh(seq=world)
    spares = [int(s) for s in args.spare.split(",") if s]

    def emit(record):
        if rank == 0:
            with open(OUT / "records.jsonl", "a") as f:
                f.write(json.dumps(record) + "\n")

    def timed(fn):
        """fn(state), a fresh copy of the carried state made before the
        window."""
        out = []
        for _ in range(args.reps):
            st = fresh()
            sync()
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            fn(st)
            sync()
            out.append((time.perf_counter() - t0) * 1e3)
        mine = statistics.median(out)
        return [row[0] for row in cards.gather_floats([mine], device)]

    if args.train:
        _train_mode(args, comm, rank, world, device, emit)
        dist.barrier()
        dist.destroy_process_group()
        return
    for shape in args.shapes.split(","):
        b, l, n = (int(x) for x in shape.split("x"))
        gen = torch.Generator(device=device).manual_seed(rank)
        q, k, v = (torch.randn((b, l, n, 128), generator=gen, device=device)
                   .to(torch.bfloat16) for _ in range(3))
        state0 = flash_attention_carry(q, k, v, None, None, last=False)

        def fresh():
            return CarryState(*(None if x is None else x.clone()
                                for x in state0))

        def step(spare, st):
            return flash_attention_carry(q, k, v, None, st, last=False,
                                         spare_sms=spare)

        def shift(x=None):
            src = x or (k, v)
            return [comm.ring_shift_start(t, "seq", -1) for t in src]

        def chain(spare, st):
            first = shift()
            step(spare, st)
            second = shift(first)  # ready while the kernel runs
            for p in first + second:
                p.wait()

        full = step(0, fresh())
        for spare in spares:
            got = step(spare, fresh())
            same = all(a is b_ or torch.equal(a, b_)
                       for a, b_ in zip(full, got))
            if not same:
                raise RuntimeError(f"{shape}: the state at sms - {spare} "
                                   "blocks is not the full grid's")
        sync()
        emit(dict(case="grids_bit_equal", shape=shape, spares=spares,
                  equal=True))
        emit(dict(case="kernel", shape=shape, spare=0,
                  ms=timed(lambda st: step(0, st))))
        for spare in spares:
            emit(dict(case="kernel", shape=shape, spare=spare,
                      ms=timed(lambda st: step(spare, st))))
        emit(dict(case="shift", shape=shape, mb=2 * k.numel() * 2 / 1e6,
                  ms=timed(lambda st: [p.wait() for p in shift()])))
        for spare in [0, *spares]:
            emit(dict(case="chain", shape=shape, spare=spare,
                      ms=timed(lambda st: chain(spare, st))))
        for spare in dict.fromkeys([0, max(spares, default=0)]):
            sync()
            dist.barrier()
            logdir = OUT / f"{shape}_spare{spare}_rank{rank}"
            st = fresh()
            with trace(logdir, device) as tr:
                chain(spare, st)
            summary = cards.profile_summary(tr, 1)
            grids = {}
            for ev in json.loads(pathlib.Path(tr.path).read_text()).get(
                    "traceEvents", []):
                name = ev.get("name", "")
                if ev.get("cat") == "kernel" and name.startswith("nccl"):
                    grids[name.split("(")[0]] = ev.get("args", {}).get(
                        "grid")
            summary["nccl_grid"] = grids
            cards.write_profile(OUT, f"{shape}_spare{spare}", rank, summary)
            dist.barrier()
            if rank == 0:
                emit(dict(case="chain_traced", shape=shape, spare=spare,
                          profile=cards.read_profiles(
                              OUT, f"{shape}_spare{spare}", world)))
        del q, k, v, state0, full
        torch.cuda.empty_cache()
    dist.barrier()
    dist.destroy_process_group()


def _train_mode(args, comm, rank, world, device, emit):
    """``--train``: the ring's forward and backward under autograd in
    both schedules, bit for bit, timed and traced."""
    import torch.distributed as dist

    from moviigen_tpu_torch.utils.profiling import trace

    schedules = {"overlapped": OverlappedRing,
                 "synchronous": ring.RingAttention}
    streams = cards.comm_streams(comm, device, OUT, rank)

    def sync():
        torch.cuda.synchronize(device)

    for shape in args.train_shapes.split(","):
        b, l, n = (int(x) for x in shape.split("x"))
        gen = torch.Generator(device=device).manual_seed(rank)
        q, k, v, g = (torch.randn((b, l, n, 128), generator=gen,
                                  device=device).to(torch.bfloat16)
                      for _ in range(4))

        def step(fn):
            x = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = fn.apply(*x, None, comm, "seq", 128 ** -0.5, "auto")
            out.backward(g)
            return [out.detach()] + [t.grad for t in x]

        got = {name: step(fn) for name, fn in schedules.items()}
        same = all(torch.equal(a, b_) for a, b_ in
                   zip(got["overlapped"], got["synchronous"]))
        sync()
        equal = [row[0] for row in cards.gather_floats([float(same)],
                                                       device)]
        emit(dict(case="train_bit_equal", shape=shape, ranks=equal))
        if not all(equal):
            raise RuntimeError(f"{shape}: the overlapped ring's out, dq, "
                               "dk, dv are not the synchronous ring's")
        del got
        for name, fn in schedules.items():
            times = []
            for _ in range(args.reps):
                sync()
                dist.barrier()
                sync()
                t0 = time.perf_counter()
                step(fn)
                sync()
                times.append((time.perf_counter() - t0) * 1e3)
            emit(dict(case="train", shape=shape, schedule=name, ms=[
                row[0] for row in cards.gather_floats(
                    [statistics.median(times)], device)]))
            sync()
            dist.barrier()
            with trace(OUT / f"train_{shape}_{name}_rank{rank}",
                       device) as tr:
                step(fn)
            cards.write_profile(OUT, f"train_{shape}_{name}", rank,
                                cards.profile_summary(tr, 1, streams))
            dist.barrier()
            if rank == 0:
                profiles = cards.read_profiles(OUT, f"train_{shape}_{name}",
                                               world)
                emit(dict(case="train_traced", shape=shape, schedule=name,
                          nccl_waits=cards.waits_of(profiles),
                          profile=profiles))


def main():
    import shutil

    args = _parser().parse_args()
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    from moviigen_tpu_torch import kernels

    kernels.build(kernels.KERNELS)  # once, not by every rank
    seconds = cards.launch(pathlib.Path(__file__).resolve(), sys.argv[1:],
                           args.ranks, OUT / "launch.log", args.timeout)
    for line in (OUT / "records.jsonl").read_text().splitlines():
        print(line, flush=True)
    print(json.dumps({"launch_s": seconds, "ranks": args.ranks}))
    for line in cards.card_lines():
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    if "--worker" in sys.argv:
        worker([a for a in sys.argv[1:] if a != "--worker"])
    else:
        sys.exit(main())
