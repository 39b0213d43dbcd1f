"""What the harness finds by name, and the result line.

Everything that belongs to one cell, configuration, traffic mix or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

- a cell: its entry in ``BENCHMARK.json``'s ``workloads`` (configuration,
  traffic, chips) and ``limits/<cell>.json`` (the limit of each number
  its check compares, with the readings it was set from);
- a configuration: ``configs/<name>.json``;
- a traffic mix: ``traffic/<name>.json``, whose ``driver`` names the
  general generator that reads it (``<driver>.py`` beside this file, such
  as ``serve.py`` or ``finetune.py``);
- a per-layer metric: its entry in ``per_layer`` and
  ``metrics/<name>.py``, whose ``read(ctx)`` gives its value, or None
  where the window holds nothing for it to read.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import pathlib
import sys
from typing import Callable, Dict, List, Optional

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no run may load: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "moviigen_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is, as
    a whole, one of ``FORBIDDEN``."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".", 1)[0] in FORBIDDEN)


class Bench:
    """The benchmark as ``BENCHMARK.json`` and the files under ``root /
    benchmark`` define it."""

    def __init__(self, root: pathlib.Path = ROOT):
        self.root = pathlib.Path(root)
        self.dir = self.root / "benchmark"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def _json(self, sub: str, name: str) -> dict:
        path = self.dir / sub / f"{name}.json"
        if not path.is_file():
            raise FileNotFoundError(f"no {sub} file {path}")
        return json.loads(path.read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        t = self._json("traffic", name)
        driver = str(t.get("driver"))
        path = self.dir / f"{driver}.py"
        if not (driver.isidentifier() and path.is_file()):
            raise ValueError(f"traffic {name}: no driver {path}")
        return t

    def limits(self, cell: str) -> Dict[str, float]:
        return {k: float(v["limit"])
                for k, v in self._json("limits", cell)["limits"].items()}

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        """The metrics a run of ``cell`` reports: the end-to-end ones
        without ``--trace``, the per-layer ones with it. A metric with a
        ``workloads`` list is in those cells only; a per-layer metric
        without one, in every cell that reports the end-to-end metric it
        ``moves``."""
        def here(m):
            return "workloads" not in m or cell in m["workloads"]

        e2e = [m for m in self.spec["end_to_end"] if here(m)]
        if not trace:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if here(m) and m["moves"] in moved]

    def reader(self, metric: str) -> Callable[[dict], Optional[float]]:
        path = self.dir / "metrics" / f"{metric}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no reader {path} for {metric}")
        mod_name = "benchmark_metric_" + "".join(
            c if c.isalnum() else "_" for c in metric)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def judge(readings: Dict[str, float], limits: Dict[str, float]):
    """Each compared number beside its limit, and whether all are within
    them (a number that is not finite is not)."""
    checks = {k: (v, limits[k]) for k, v in readings.items()}
    correct = all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    return checks, correct


def log(what: str) -> None:
    """A phase's end on standard error, with the process's age."""
    print(f"[bench {process_age():8.2f} s] {what}", file=sys.stderr,
          flush=True)


def process_age() -> float:
    """Seconds since this process started (``/proc``: the kernel's start
    time of the process, which an ``exec`` keeps)."""
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    return uptime - start / os.sysconf("SC_CLK_TCK")


def result_line(res: dict, metrics: List[dict], readers: dict,
                trace: bool, device: dict) -> dict:
    """The contract's last line: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last the
    compared numbers beside their limits (``checks``)."""
    out_metrics = {}
    for m in metrics:
        name = m["name"]
        value = (readers[name](res["ctx"]) if trace
                 else res["end_to_end"].get(name))
        if value is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {name} not measured")
            continue
        out_metrics[name] = {"value": value, "unit": m["unit"]}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": out_metrics,
            "device": device}
    if trace and res.get("window") is not None:
        line["breakdown"] = res["window"].breakdown()
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in res["checks"].items()}
    return line
