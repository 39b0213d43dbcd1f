"""Profiling and tracing utilities of the PyTorch port.

Counterpart of ``moviigen_tpu/utils/profiling.py`` (ref: the manual phase
timing of ``finetune.py:190-263``, ``timing_stats``):

- ``trace(logdir)`` captures a ``torch.profiler`` trace (CPU, plus CUDA
  when the device is a card) and writes it into ``logdir`` as a Chrome
  trace (``chrome://tracing``, Perfetto, or TensorBoard's profiler plugin,
  which reads ``*.pt.trace.json``); the device kernels' launch counts and
  times are read from the profiler before the export;
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
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass
class Trace:
    """What ``trace`` wrote: the Chrome trace's path and, per device
    kernel, its (launches, device ms) over the traced window. Both are
    filled when the window closes."""

    path: Optional[str] = None
    kernels: Dict[str, Tuple[int, float]] = dataclasses.field(
        default_factory=dict)


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
