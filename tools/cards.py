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
- ``draw_live_heads`` makes the random DiT's head live, as a
  checkpoint's is: ``WanModel.init_weights`` zeroes it, and a zero head
  makes every prediction zero whatever the blocks compute, so that a
  parity check of the blocks would hold vacuously.
"""

from __future__ import annotations

import os
import pathlib
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


def profile_summary(tr, blocks: int) -> dict:
    """A traced step's ``comm_overlap`` (ms, rounded to the µs) with the
    exposed NCCL time per block of the stack, and its five largest
    compute kernels by device ms, (name, launches, ms)."""
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
    return out


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
