"""The traced window: ``torch.profiler`` over the measured window, read
from its raw kineto events (no Chrome trace is written).

The interval arithmetic (``union``, ``length``) and the rule that keeps
the profiler's own ranges out of the device's work (``is_annotation``)
are copied from ``moviigen_tpu_torch/utils/profiling.py`` (``_union``,
``_length``, ``_annotation``, ``device_intervals``; commit 503dac0). The
kernel categories are read from ``kernel_categories.json``, a copy of
``chip_smoke.py::_kernel_category`` as data.

``Window`` gives what the per-layer readers and the result's ``device``
and ``breakdown`` need: the window's seconds, the seconds in which any
device activity ran (a union, so streams that overlap count once), the
device seconds of each kernel category, the device operations that took
most time, and the device's idle gaps by what the main thread of the
host was doing when each began.

On the card only the CUDA activity is traced: kernels, copies and the
host's CUDA runtime and driver calls. Tracing every host operator as well
costs the host some microseconds an operator, which the untraced run does
not pay: on an H100 the 1.3B fine-tune step (≈ 20,000 launches) took
4.0-4.4 s so, against 3.81-3.88 s untraced, and its idle share and MFU
read the profiler's cost. The window is then the span between the tracer's own
``cudaDeviceSynchronize`` calls, the first and the last CUDA calls of the
trace, and an idle gap is named by the CUDA call the host was in when it
began. Without a card (the tests) the host's operators are traced and
the window is the ``bench.window`` range.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from .core import log

HERE = pathlib.Path(__file__).resolve().parent
WINDOW_RANGE = "bench.window"
# the tracer's marks of the window's start and end on the card
MARK = "cudaDeviceSynchronize"
NO_RANGE = "(host outside any traced call)"


def union(spans) -> List[Tuple[int, int]]:
    """Sorted, disjoint (start, end) spans covering ``spans``."""
    out: List[List[int]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def length(spans) -> int:
    return sum(e - s for s, e in spans)


def clip(spans, lo: int, hi: int) -> List[Tuple[int, int]]:
    return [(max(s, lo), min(e, hi)) for s, e in spans if e > lo and s < hi]


def gaps(busy, lo: int, hi: int) -> List[Tuple[int, int]]:
    """The spans of [lo, hi) that no span of the union ``busy`` covers."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out


def is_annotation(e) -> bool:
    """A range the profiler draws around work on the device timeline
    (NCCL's ``nccl:<op>``, a ``record_function`` range such as the
    harness's ``bench.*``), not work."""
    said = getattr(e, "is_user_annotation", None)
    return (e.name().startswith(("nccl:", "bench."))
            or (said is not None and said()))


class Categories:
    def __init__(self, path=HERE / "kernel_categories.json"):
        table = json.loads(pathlib.Path(path).read_text())
        self.rules = [(tuple(t.lower() for t in r["match"]), r["category"])
                      for r in table["rules"]]
        self.default = table["default"]

    def __call__(self, name: str) -> str:
        low = name.lower()
        for tags, cat in self.rules:
            if any(t in low for t in tags):
                return cat
        return self.default


def innermost(host, points):
    """For each time in ``points`` (sorted), the name of the innermost
    host range (``host``: (start, end, name) of one thread, sorted by
    start, properly nested) that covers it, or None."""
    out, stack, i = [], [], 0
    for t in points:
        while i < len(host) and host[i][0] <= t:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


class Window:
    """What a traced window held (see the module's docstring)."""

    def __init__(self, events, categories: Categories):
        from torch.autograd import DeviceType

        device, host, window, marks = [], defaultdict(list), None, []
        for e in events:
            start, end = e.start_ns(), e.start_ns() + e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                if not is_annotation(e):
                    device.append((e.name(), start, end))
            else:
                host[e.start_thread_id()].append((start, end, e.name()))
                if e.name() == WINDOW_RANGE:
                    window = (start, end, e.start_thread_id())
                elif e.name() == MARK:
                    marks.append((start, end, e.start_thread_id()))
        self.marked_by = WINDOW_RANGE
        if window is None and len(marks) >= 2:
            marks.sort()
            window = (marks[0][1], marks[-1][0], marks[0][2])
            self.marked_by = MARK
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW_RANGE} range "
                               f"and not two {MARK} calls")
        lo, hi, main = window
        self.window_s = (hi - lo) / 1e9
        busy = union(clip([(s, e) for _, s, e in device], lo, hi))
        self.busy_s = length(busy) / 1e9
        self.kernels = len(device)
        by_cat: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        by_op: Dict[str, float] = defaultdict(float)
        for name, s, e in device:
            span = clip([(s, e)], lo, hi)
            if span:
                by_cat[categories(name)].extend(span)
                by_op[name] += length(span) / 1e9
        self.category_s = {c: length(union(v)) / 1e9
                           for c, v in by_cat.items()}
        self.top_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        holes = gaps(busy, lo, hi)
        names = innermost(sorted(r for r in host[main]
                                 if r[2] != WINDOW_RANGE),
                          [s for s, _ in holes])
        idle: Dict[str, float] = defaultdict(float)
        for (s, e), name in zip(holes, names):
            idle[name or NO_RANGE] += (e - s) / 1e9
        self.idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]

    def breakdown(self) -> dict:
        return {"device_ops": [[n[:160], s] for n, s in self.top_ops],
                "idle_gaps": [[n[:160], s] for n, s in self.idle_gaps]}


class Tracer:
    """``with tracer.window():`` around the measured window. Off
    (``enabled`` false) it marks nothing; on, it profiles from ``start()``
    to ``stop()`` (on the card its CUDA activity, without one the host's
    operators) and reads the window."""

    def __init__(self, enabled: bool, cuda: bool):
        self.enabled, self.cuda = enabled, cuda
        self.prof = None
        self.result: Optional[Window] = None

    def start(self):
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA if self.cuda else ProfilerActivity.CPU]
        self.prof = profile(activities=acts)
        self.prof.start()
        if self.cuda:
            import torch

            torch.cuda.synchronize()  # the window's first mark

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        import torch

        with torch.profiler.record_function(WINDOW_RANGE):
            yield

    def stop(self) -> Optional[Window]:
        if not self.enabled:
            return None
        import torch

        if self.cuda:
            torch.cuda.synchronize()  # the window's last mark
        self.prof.stop()
        self.result = Window(self.prof.profiler.kineto_results.events(),
                             Categories())
        self.prof = None
        log(f"trace: {self.result.kernels} device operations, the window "
            f"marked by {self.result.marked_by}")
        return self.result

