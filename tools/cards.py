"""What the across-card tools share (``tools/sp_serve_cards.py``,
``tools/sp_train_cards.py``): the ``torchrun`` launch of a worker, one
rank per card, the checks every rank runs, and the card lines.

- ``launch`` runs ``torch.distributed.run --standalone`` over a worker
  script in a session of its own, with ``STRICT_ENV`` (a failed
  process-group init is fatal; every rank hashes the same words; nothing
  reaches the network), its output in a log file; past its time limit the
  whole session is killed. It raises ``SystemExit`` with the log's tail
  when the launch exits non-zero.
- ``checksum`` is an exact fingerprint of a set of tensors (their bytes
  as integers, summed modulo 2**64, so the order of the sum does not
  matter); ``same_on_every_rank`` all-gathers one and raises unless every
  rank of the world holds the same: the weights each rank drew from the
  seed before it cut its shards.
- ``gather_floats`` collects a few numbers from every rank (peak GiB).
- ``profile_summary`` reduces a traced step (``utils/profiling.trace``)
  to what the tools' ``--profile`` records: device ms of compute and of
  NCCL, NCCL ms under compute, exposed NCCL ms (in all, per block and by
  NCCL kernel), the idle share and the largest compute kernels; each
  rank writes its own (``write_profile``) and rank 0 reads them all
  (``read_profiles``).
- ``comm_streams`` names the stream each of a rank's NCCL groups runs
  on (a traced window of one small op per group), and ``nccl_ops`` reads
  a traced step's NCCL kernels from its Chrome trace by group and op
  (send/receive, all-gather, reduce-scatter, all-reduce), with the
  compute kernel that ran last before each; ``nccl_waits`` lines every
  op up across the ranks of its group and splits its time into the wait
  for the last rank to arrive and the rest, and names what the last
  rank ran before it arrived;
- ``draw_live_heads`` makes the random DiT's head live, as a
  checkpoint's is: ``WanModel.init_weights`` zeroes it, and a zero head
  makes every prediction zero whatever the blocks compute, so that a
  parity check of the blocks would hold vacuously;
- ``free``, ``launch_counts`` and ``reset_launch_counts`` are the tools'
  memory and kernel-launch bookkeeping.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import signal
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
STRICT_ENV = {
    # a failed init_process_group raises (parallel/distributed.py)
    "MOVIIGEN_STRICT_DISTRIBUTED": "1",
    # the hash tokenizer hashes words with Python's hash(): one salt for
    # every rank and every one-card reference
    "PYTHONHASHSEED": "0",
    "OMP_NUM_THREADS": "1",
    "HF_HUB_OFFLINE": "1",
    "TRANSFORMERS_OFFLINE": "1",
}


def launch(script, worker_args, nproc: int, log_path, timeout: float,
           env=None) -> float:
    """``torchrun --standalone --nproc_per_node nproc script --worker
    worker_args``; returns its seconds. Output (every rank's) goes to
    ``log_path``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), str(script), "--worker",
           *map(str, worker_args)]
    full_env = dict(os.environ, **STRICT_ENV, **(env or {}))
    log_path = pathlib.Path(log_path)
    log_path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        log.write(" ".join(cmd) + "\n")
        log.flush()
        proc = subprocess.Popen(cmd, cwd=ROOT, env=full_env, stdout=log,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = f"killed after {timeout:.0f} s"
    seconds = time.perf_counter() - t0
    if rc != 0:
        tail = log_path.read_text(errors="replace")[-12000:]
        print(tail, file=sys.stderr, flush=True)
        raise SystemExit(f"launch of {nproc} ranks ({' '.join(map(str, worker_args))[:200]}) "
                         f"failed: {rc}; log {log_path}")
    return seconds


def card_lines() -> list:
    """Every visible card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise SystemExit(f"nvidia-smi failed: {out.stderr.strip()}")
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def _leaves(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)
    elif tree is not None:  # a module
        for _, t in sorted(tree.state_dict(keep_vars=True).items()):
            yield t


_INT = {1: "int8", 2: "int16", 4: "int32", 8: "int64"}


def checksum(*trees):
    """An int64 [3] fingerprint of every tensor in ``trees`` (modules,
    dicts, lists of tensors): the count of elements, the sum of their
    bytes read as integers, and the sum weighted by position; all exact,
    modulo 2**64."""
    import torch

    total = None
    for t in (x for tree in trees for x in _leaves(tree)):
        t = t.detach().contiguous().reshape(-1)
        v = t.view(getattr(torch, _INT[t.element_size()])).long()
        w = torch.arange(v.numel(), device=v.device) % 1021 + 1
        part = torch.stack([torch.tensor(v.numel(), device=v.device),
                            v.sum(), (v * w).sum()])
        total = part if total is None else total + part
    return total


def gather_floats(values, device):
    """``values`` (a few floats) from every rank of the world, in rank
    order: a list of lists."""
    import torch
    import torch.distributed as dist

    mine = torch.tensor(values, dtype=torch.float64, device=device)
    out = mine.new_empty(dist.get_world_size() * mine.numel())
    dist.all_gather_into_tensor(out, mine)
    return out.reshape(-1, mine.numel()).tolist()


def same_on_every_rank(fingerprint, what: str) -> list:
    """Raise unless ``fingerprint`` (``checksum``'s int64 [3]) is the
    same on every rank of the world; returns it as a list."""
    import torch.distributed as dist

    out = fingerprint.new_empty(dist.get_world_size() * fingerprint.numel())
    dist.all_gather_into_tensor(out, fingerprint.contiguous())
    out = out.reshape(-1, fingerprint.numel())
    if not bool((out == fingerprint).all()):
        raise RuntimeError(f"{what}: the ranks drew different tensors from "
                           f"the seed (checksums {out.tolist()})")
    return fingerprint.tolist()


def profile_summary(tr, blocks: int, streams=None) -> dict:
    """A traced step's ``comm_overlap`` (ms, rounded to the µs) with the
    exposed NCCL time per block of the stack, and its five largest
    compute kernels by device ms, (name, launches, ms). With ``streams``
    (``comm_streams``), also ``nccl_by_group`` (``nccl_by_group``) and
    ``nccl_ops``, the kernels ``nccl_waits`` lines up across ranks."""
    from moviigen_tpu_torch.utils.profiling import comm_overlap, is_nccl

    s = comm_overlap(tr.intervals, tr.window_ns)
    out = {k: round(v, 3) if isinstance(v, float) else v
           for k, v in s.items() if k != "nccl_by_kernel"}
    out["idle_share"] = round(s["idle_share"], 4)
    out["blocks"] = blocks
    out["exposed_nccl_ms_per_block"] = round(s["exposed_nccl_ms"] / blocks,
                                             3)
    out["nccl_by_kernel"] = {k: [n, round(ms, 3), round(ex, 3)]
                             for k, (n, ms, ex)
                             in s["nccl_by_kernel"].items()}
    top = sorted(((n, c, ms) for n, (c, ms) in tr.kernels.items()
                  if not is_nccl(n)), key=lambda r: -r[2])[:5]
    out["top_compute"] = [[n[:60], c, round(ms, 3)] for n, c, ms in top]
    if streams is not None:
        ops = nccl_ops(tr.path, streams["streams"])
        out["nccl_by_group"] = nccl_by_group(ops)
        out["nccl_ops"] = ops
        out["members"] = streams["members"]
    return out


def waits_of(profiles: list) -> dict:
    """``nccl_waits`` over every rank's ``profile_summary`` (those made
    with ``streams``), which then drop their ``nccl_ops``."""
    if not all("nccl_ops" in p for p in profiles):
        return {}
    waits = nccl_waits([p.pop("nccl_ops") for p in profiles],
                       [p.pop("members") for p in profiles])
    return waits


def warm_tracer(out_dir, device) -> None:
    """Trace one small kernel, so that a run's traced step does not pay
    the profiler's first start (CUPTI's set-up took a traced r1 step from
    0.53 to 0.98 s on an H100)."""
    import torch

    from moviigen_tpu_torch.utils.profiling import trace

    with trace(pathlib.Path(out_dir) / "profile" / "warm-up", device):
        torch.ones(8, device=device).add_(1)


def write_profile(out_dir, name: str, rank: int, summary) -> None:
    """This rank's ``profile_summary`` of run ``name`` (None: not
    traced), for rank 0 to read once every rank has written."""
    import json

    path = pathlib.Path(out_dir) / f"{name}.profile.rank{rank}.json"
    path.write_text(json.dumps(summary))


def read_profiles(out_dir, name: str, world: int) -> list:
    """Every rank's ``write_profile`` of run ``name``, in rank order."""
    import json

    return [json.loads((pathlib.Path(out_dir)
                        / f"{name}.profile.rank{r}.json").read_text())
            for r in range(world)]


def peak_gib(device) -> float:
    """``torch.cuda.max_memory_allocated`` of ``device`` in GiB (0 on the
    CPU)."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated(dev) / 2**30


def reset_peak(device) -> None:
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def draw_live_heads() -> None:
    """From here on in this process, ``WanModel.init_weights`` also draws
    the head's weight (std 0.02) from its generator after the rest."""
    import torch

    from moviigen_tpu_torch.models.wan_model import WanModel

    init = WanModel.init_weights

    def init_live(self, generator):
        init(self, generator)
        with torch.no_grad():
            self.head.weight.normal_(0.0, 0.02, generator=generator)
        return self

    WanModel.init_weights = init_live


def free(device) -> None:
    """Collect garbage and give the card's cached blocks back."""
    import gc

    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def launch_counts() -> dict:
    """The hand-written kernels' launch counters."""
    from moviigen_tpu_torch.ops import flash_attention, int8_gemm

    return {**flash_attention.launch_counts(), **int8_gemm.launch_counts()}


def reset_launch_counts() -> None:
    from moviigen_tpu_torch.ops import flash_attention, int8_gemm

    flash_attention.reset_launch_counts()
    int8_gemm.reset_launch_counts()


def allocator_stats(device) -> dict:
    """The caching allocator's counters that a step's churn moves:
    retries after a failed ``cudaMalloc`` (each frees the cache and
    synchronizes the card), ``cudaMalloc`` / ``cudaFree`` calls, and
    reserved GiB."""
    import torch

    if torch.device(device).type != "cuda":
        return {}
    st = torch.cuda.memory_stats(device)
    return {"num_alloc_retries": st.get("num_alloc_retries", 0),
            "num_device_alloc": st.get("num_device_alloc", 0),
            "num_device_free": st.get("num_device_free", 0),
            "reserved_gib": st.get("reserved_bytes.all.current", 0) / 2**30}


# ------------------------------------------- NCCL time by group and op

_KIND = re.compile(r"nccl(?:Dev)?Kernel_([A-Za-z]+)")
KINDS = {"SendRecv": "send/receive", "AllGather": "all-gather",
         "ReduceScatter": "reduce-scatter", "AllReduce": "all-reduce"}


def nccl_kind(name: str) -> str:
    """The op of an NCCL kernel, from its name."""
    m = _KIND.search(name)
    return KINDS.get(m.group(1), m.group(1)) if m else name.split("(")[0]


def _kernels(path):
    """(name, start ns, end ns, stream, grid) of every device kernel in a
    Chrome trace, in start order (one clock for every process on a
    host)."""
    data = json.loads(pathlib.Path(path).read_text())
    base = int(data.get("baseTimeNanoseconds", 0))
    out = []
    for ev in data.get("traceEvents", []):
        if ev.get("cat") != "kernel" or "dur" not in ev:
            continue
        args = ev.get("args", {})
        start = base + int(round(float(ev["ts"]) * 1000))
        out.append((ev.get("name", ""), start,
                    start + int(round(float(ev["dur"]) * 1000)),
                    args.get("stream"), args.get("grid")))
    out.sort(key=lambda k: k[1])
    return out


def comm_streams(comm, device, out_dir, rank: int) -> dict:
    """Which stream each NCCL group of ``comm`` runs on, on this rank:
    one small op per group whose axes have more than one rank, each in a
    traced window of its own, and the stream of the NCCL kernels in it.
    Returns ``{"streams": {stream: label}, "members": {label: [global
    ranks]}, "missed": [labels whose window held no NCCL kernel]}``,
    labels as ``"<kind>:<axes>"`` with kind ``sync`` (the
    collectives on the caller's stream, over the axis' own group),
    ``sync-p2p`` (the synchronous shift there: NCCL gives a group's
    send/receive a stream of its own) or ``shift`` (the asynchronous
    shift's group)."""
    import torch

    from moviigen_tpu_torch.parallel.comm import AXES, ASYNC_AXES, ready
    from moviigen_tpu_torch.parallel.sharding import shard_axis
    from moviigen_tpu_torch.utils.profiling import trace

    x = torch.ones(64, device=device)
    ops = []
    # the groups an SP step uses: the weights' axes (gathers, gradients'
    # reduce-scatters), seq (Ulysses' all-to-alls), ring (USP's
    # synchronous shifts) and the whole mesh (replicated gradients)
    keys = dict.fromkeys(comm._key(a) for a in
                         (shard_axis(comm), "seq", "ring", AXES))
    for key in keys:
        if comm.axis_size(key) < 2:
            continue
        name = ",".join(key)
        ops.append((f"sync:{name}", key,
                    lambda k=key: comm._all_reduce(x, k)))
        if key in ASYNC_AXES:
            ops.append((f"sync-p2p:{name}", key,
                        lambda k=key: comm._ring_shift(x, k)))
            ops.append((f"shift:{name}", key,
                        lambda k=key: ready(comm.ring_shift_start(x, k))))
    for _, _, op in ops:  # every communicator made before the windows
        op()
    streams, members, missed = {}, {}, []
    for n, (label, key, op) in enumerate(ops):
        torch.cuda.synchronize(device)
        with trace(pathlib.Path(out_dir) / "profile"
                   / f"streams_rank{rank}_{n}", device) as tr:
            # a window's first kernels can go unrecorded (seen on H100s
            # under torch 2.11): a few of ours first
            for _ in range(8):
                x.add_(0)
            torch.cuda.synchronize(device)
            op()
            torch.cuda.synchronize(device)
        got = [k[3] for k in _kernels(tr.path) if k[0].startswith("nccl")]
        if not got:  # left unnamed: its kernels read as stream<id>
            missed.append(label)
        streams.update((str(st), label) for st in got)
        members[label] = [comm.ranks[p] for p in comm.group(key)]
    return {"streams": streams, "members": members, "missed": missed}


def nccl_ops(path, streams: dict) -> list:
    """A traced step's NCCL kernels (its Chrome trace at ``path``) in
    start order: [group label (``comm_streams``; else ``stream<id>``),
    op, start ns, end ns, ns under compute, CTAs, the compute kernel that
    ended last before it started]."""
    from moviigen_tpu_torch.utils.profiling import _overlap, _union

    ks = _kernels(path)
    comp = [k for k in ks if not k[0].startswith("nccl")]
    comp_u = _union((k[1], k[2]) for k in comp)
    ends = sorted((k[2], k[0]) for k in comp)
    out, j, last = [], 0, ""
    for name, s, e, stream, grid in ks:
        if not name.startswith("nccl"):
            continue
        while j < len(ends) and ends[j][0] <= s:
            last = ends[j][1]
            j += 1
        ctas = grid[0] * grid[1] * grid[2] if grid else None
        out.append([streams.get(str(stream), f"stream{stream}"),
                    nccl_kind(name), s, e, _overlap([(s, e)], comp_u),
                    ctas, last[:60]])
    return out


def nccl_by_group(ops: list) -> dict:
    """One rank's ``nccl_ops`` summed by ``"<group> <op>"``: [kernels,
    ms, exposed ms (with no compute running), CTAs of the widest]."""
    out = {}
    for label, kind, s, e, under, ctas, _ in ops:
        row = out.setdefault(f"{label} {kind}", [0, 0.0, 0.0, 0])
        row[0] += 1
        row[1] += (e - s) / 1e6
        row[2] += (e - s - under) / 1e6
        row[3] = max(row[3], ctas or 0)
    return {k: [n, round(ms, 3), round(ex, 3), c]
            for k, (n, ms, ex, c) in out.items()}


def nccl_waits(per_rank: list, members: list) -> dict:
    """Every rank's ``nccl_ops`` (rank order) lined up op by op within
    each group (the k-th op of a group on one member is the k-th on every
    member: the code is SPMD) over ``members`` (each rank's
    ``comm_streams`` members). Per ``"<group> <op>"``: each rank's ms of
    waiting for the last member to arrive (its start to the last start)
    and ms after it, how often each rank arrived last, and what the last
    rank ran before it arrived, by the wait it caused (ms, top 6)."""
    rows, blame = {}, {}
    seen = set()
    for r, ops in enumerate(per_rank):
        for label, ranks in members[r].items():
            group = tuple(ranks)
            if (label, group) in seen:
                continue
            seen.add((label, group))
            seq = {m: [op for op in per_rank[m] if op[0] == label]
                   for m in group}
            n = min(len(v) for v in seq.values())
            for k in range(n):
                ops_k = {m: seq[m][k] for m in group}
                last = max(group, key=lambda m: ops_k[m][2])
                t_last = ops_k[last][2]
                key = f"{label} {ops_k[last][1]}"
                row = rows.setdefault(key, {
                    "wait_ms": [0.0] * len(per_rank),
                    "after_ms": [0.0] * len(per_rank),
                    "last": [0] * len(per_rank), "ops": 0})
                row["ops"] += 1
                row["last"][last] += 1
                caused = 0.0
                for m, op in ops_k.items():
                    wait = (t_last - op[2]) / 1e6
                    row["wait_ms"][m] += wait
                    row["after_ms"][m] += max(0, op[3] - t_last) / 1e6
                    caused += wait
                what = blame.setdefault(key, {})
                before = ops_k[last][6] or "(nothing)"
                what[before] = what.get(before, 0.0) + caused
    for key, row in rows.items():
        row["wait_ms"] = [round(x, 3) for x in row["wait_ms"]]
        row["after_ms"] = [round(x, 3) for x in row["after_ms"]]
        top = sorted(blame[key].items(), key=lambda kv: -kv[1])[:6]
        row["last_rank_ran_before"] = [[n, round(ms, 3)] for n, ms in top]
    return rows
