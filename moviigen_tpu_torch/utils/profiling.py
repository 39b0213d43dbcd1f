"""Profiling and tracing utilities of the PyTorch port.

Counterpart of ``moviigen_tpu/utils/profiling.py`` (ref: the manual phase
timing of ``finetune.py:190-263``, ``timing_stats``):

- ``trace(logdir)`` captures a ``torch.profiler`` trace (CPU, plus CUDA
  when the device is a card) and writes it into ``logdir`` as a Chrome
  trace (``chrome://tracing``, Perfetto, or TensorBoard's profiler plugin,
  which reads ``*.pt.trace.json``); the device kernels' launch counts and
  times, and every device activity's interval, are read from the profiler
  before the export;
- ``comm_overlap`` splits a trace's device time between NCCL kernels and
  the rest: how much of the collectives' time ran under other work, how
  much was exposed, and the device's idle share;
- ``sync`` waits for the device, through a scalar readback when given a
  tree of tensors;
- ``PhaseTimer`` keeps per-phase wall-clock totals in the JAX record format.

``enable_persistent_compilation_cache`` is not ported, by design: eager
PyTorch compiles no programs per process, and the hand-written kernels are
kept under ``_build/`` by a hash of their source (``kernels.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import socket
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch


Interval = Tuple[str, int, int]  # (name, start ns, end ns)


@dataclasses.dataclass
class Trace:
    """What ``trace`` wrote: the Chrome trace's path; per device kernel,
    its (launches, device ms) over the traced window; every device
    activity's interval; and the window itself, (start ns, end ns) of the
    first and last event the profiler saw, host or device. All are filled
    when the window closes."""

    path: Optional[str] = None
    kernels: Dict[str, Tuple[int, float]] = dataclasses.field(
        default_factory=dict)
    intervals: List[Interval] = dataclasses.field(default_factory=list)
    window_ns: Tuple[int, int] = (0, 0)


def device_kernels(prof) -> Dict[str, Tuple[int, float]]:
    """(launches, device ms) of every device activity (kernels, copies,
    fills) a finished ``torch.profiler.profile`` saw, by name. Read from
    the profiler's raw events: ``key_averages()`` builds a Python event
    tree first and takes seconds per ten thousand events, as long as the
    steps it would summarize."""
    from torch.autograd import DeviceType

    out: Dict[str, Tuple[int, float]] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        count, ms = out.get(e.name(), (0, 0.0))
        out[e.name()] = (count + 1, ms + e.duration_ns() / 1e6)
    return out


def device_intervals(prof) -> Tuple[List[Interval], Tuple[int, int]]:
    """Every device activity of a finished ``torch.profiler.profile``
    (kernels, copies, fills; not the ranges the profiler annotates on the
    device timeline, such as ``nccl:all_to_all`` around NCCL's kernel) as
    (name, start ns, end ns), in start order, and the window (start ns,
    end ns) spanned by all its events, host and device (one clock)."""
    from torch.autograd import DeviceType

    out, lo, hi = [], None, None
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        lo = start if lo is None else min(lo, start)
        hi = end if hi is None else max(hi, end)
        if e.device_type() == DeviceType.CUDA and not _annotation(e):
            out.append((e.name(), start, end))
    out.sort(key=lambda iv: iv[1])
    return out, (lo or 0, hi or 0)


def _annotation(e) -> bool:
    """Whether a profiler event is a range drawn around work, not work:
    NCCL's ``nccl:<op>`` on the device timeline, or any user annotation
    where the event says so (torch 2.11's events have no
    ``is_user_annotation``; there the name tells)."""
    said = getattr(e, "is_user_annotation", None)
    return e.name().startswith("nccl:") or (said is not None and said())


def is_nccl(name: str) -> bool:
    """Whether a device activity is one of NCCL's kernels."""
    return name.startswith("nccl")


def _union(spans) -> List[Tuple[int, int]]:
    """Sorted, disjoint (start, end) spans covering ``spans``."""
    out: List[List[int]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _length(spans) -> int:
    return sum(e - s for s, e in spans)


def _overlap(a, b) -> int:
    """The length of the intersection of two unions (``_union``)."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def comm_overlap(intervals: List[Interval],
                 window_ns: Tuple[int, int]) -> Dict[str, object]:
    """How a traced window's collectives sat beside its other device work
    (a ``Trace``'s ``intervals`` and ``window_ns``). Times in ms, each a
    union of intervals, so work on several streams at once counts once:

    - ``compute_ms``: device time of every activity that is not NCCL's
      (kernels, copies, fills), ``nccl_ms`` of NCCL's kernels, which run
      from their launch until their peers' data has moved, waits
      included;
    - ``nccl_under_compute_ms``: NCCL time with other work running;
    - ``exposed_nccl_ms``: NCCL time with nothing else running;
    - ``idle_share``: the window's share with no device activity;
    - ``nccl_by_kernel``: per NCCL kernel name, (launches, ms, exposed
      ms)."""
    comp = _union((s, e) for n, s, e in intervals if not is_nccl(n))
    nccl_iv = [(n, s, e) for n, s, e in intervals if is_nccl(n)]
    nccl = _union((s, e) for _, s, e in nccl_iv)
    busy = _union([*comp, *nccl])
    under = _overlap(nccl, comp)
    by_kernel: Dict[str, List[float]] = {}
    for n, s, e in nccl_iv:
        row = by_kernel.setdefault(n.split("(")[0], [0, 0.0, 0.0])
        row[0] += 1
        row[1] += (e - s) / 1e6
        row[2] += ((e - s) - _overlap([(s, e)], comp)) / 1e6
    window = max(1, window_ns[1] - window_ns[0])
    return {"window_ms": window / 1e6,
            "compute_ms": _length(comp) / 1e6,
            "nccl_ms": _length(nccl) / 1e6,
            "nccl_under_compute_ms": under / 1e6,
            "exposed_nccl_ms": (_length(nccl) - under) / 1e6,
            "idle_share": 1.0 - _length(busy) / window,
            "nccl_by_kernel": {k: tuple(v) for k, v in by_kernel.items()}}


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """Capture a torch.profiler trace of the enclosed code into
    ``logdir`` (``<host>_<pid>.<ms>.pt.trace.json``). CUDA activity is
    traced when ``device`` is a CUDA device (default: when a card is
    present). Yields a ``Trace``."""
    from torch.profiler import ProfilerActivity, profile

    cuda = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available())
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    out = Trace()
    prof = profile(activities=activities)
    prof.start()
    try:
        yield out
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        out.kernels = device_kernels(prof)
        out.intervals, out.window_ns = device_intervals(prof)
        out.path = os.path.join(
            logdir, f"{socket.gethostname()}_{os.getpid()}."
                    f"{time.time_ns() // 1_000_000}.pt.trace.json")
        prof.export_chrome_trace(out.path)


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]  # jax.tree_leaves' order
    if isinstance(tree, (list, tuple)):
        for leaf in tree:
            found = _first_tensor(leaf)
            if found is not None:
                return found
    return None


def sync(tree=None) -> None:
    """Wait for the device. With a tree (a tensor, or dicts, lists and
    tuples of them), read back one scalar of its first tensor, as the JAX
    module does; otherwise synchronize the current CUDA device, if any."""
    if tree is None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return
    first = _first_tensor(tree)
    if first is not None:
        first.reshape(-1)[0].item()


class PhaseTimer:
    """Accumulates per-phase wall-clock stats (ref ``timing_stats``)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync_tree=None):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        yield
        if sync_tree is not None:
            sync(sync_tree)
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1

    def averages(self) -> Dict[str, float]:
        return {k: self.totals[k] / max(1, self.counts[k])
                for k in self.totals}

    def report(self) -> str:
        return " ".join(f"{k}={v * 1e3:.1f}ms"
                        for k, v in sorted(self.averages().items()))
