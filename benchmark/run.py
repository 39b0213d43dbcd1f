#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch/CUDA port
(``moviigen_tpu_torch``) once, on the CUDA card(s) of this machine:

    python3 benchmark/run.py --workload t2v14b.480p81 --seed 7 \\
        --seconds 30 --trace 0

Loads and warms up (set-up), measures for ``--seconds``, checks what the
measured path produced against the plain reference under
``benchmark/reference/``, and prints one JSON line last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones, read from a
``torch.profiler`` trace of the window), ``device`` and, last, ``checks``:
each number the check compared with its limit. The same numbers are the
last lines of standard error.

Without a CUDA card, or with fewer cards than the cell asks for, it
prints no result and exits 2; it never falls back to the CPU. It exits 3,
printing no result, if JAX or the JAX package ``moviigen_tpu`` was loaded
in this process.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

# Set before Python starts (PYTHONHASHSEED) or before the program is
# imported: the hash tokenizer's ids follow Python's string hash, so one
# salt for every run; no library loads JAX or reaches the network; the
# Triton cache sits at a fixed place in the checkout.
ENV = {
    "PYTHONHASHSEED": "0",
    "USE_FLAX": "0", "USE_JAX": "0", "USE_TF": "0",
    "HF_HUB_OFFLINE": "1", "TRANSFORMERS_OFFLINE": "1",
    "TOKENIZERS_PARALLELISM": "false",
    "TRITON_CACHE_DIR": str(ROOT / ".bench_cache" / "triton"),
    "TORCH_EXTENSIONS_DIR": str(ROOT / ".bench_cache" / "torch_extensions"),
}


def ensure_env() -> None:
    """Start this script again under ``ENV`` unless Python already runs
    with its hash seed; then set the rest of ``ENV``."""
    if os.environ.get("PYTHONHASHSEED") != ENV["PYTHONHASHSEED"]:
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, **ENV})
    os.environ.update(ENV)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_entry(chips: int, peak: int, window) -> dict:
    import torch

    from moviigen_tpu_torch import kernels

    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips, "memory_peak_bytes": peak,
           "card": kernels.card_line()}
    if window is not None:
        dev.update(busy_s=window.busy_s, window_s=window.window_s)
    return dev


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import core

    bench = core.Bench(ROOT)
    cell = bench.cell(args.workload)
    driver = bench.traffic(cell["traffic"])["driver"]
    metrics = bench.metrics(cell["name"], bool(args.trace))
    readers = ({m["name"]: bench.reader(m["name"]) for m in metrics}
               if args.trace else {})

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} cards, this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2

    import importlib

    drive = importlib.import_module(f"benchmark.{driver}")
    res = drive.run(bench, cell, args.seed, args.seconds, bool(args.trace),
                    "cuda")
    loaded = core.forbidden_modules()
    if loaded:
        print(f"JAX or the JAX package was loaded: {loaded}",
              file=sys.stderr)
        return 3
    line = core.result_line(res, metrics, readers, bool(args.trace),
                            device_entry(cell["chips"], res["peak_bytes"],
                                         res["window"]))
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    ensure_env()
    sys.exit(main())
