#!/usr/bin/env python3
"""The controls of the benchmark's checks, on the card: for each seed, one
run of the cell as ``run.py`` makes it (its own readings, the lower end of
each limit), then the control's readings (the upper end):

- serving cells: the checked request answered again by the program with
  its W8A8 path switched on (int8, one precision below the bf16 the
  configuration serves in), and the VAE decode computed by the reference
  with every convolution's operands rounded through fp8;
- fine-tune cells: the reference with every linear's operands rounded
  through fp8, in the program's place.

    python3 benchmark/control.py --workload t2v14b.480p81 \\
        --seeds 11,12,13 --seconds 1

One JSON line a seed on standard output: the program's readings and
``correct``, the control's readings and ``control_correct``, both judged
by the cell's limits as a run judges (``core.judge``); a control must
come out not correct. The benchmark's own runs never run a control.
"""

from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import core

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = core.Bench(ROOT)
    cell = bench.cell(args.workload)
    drive = importlib.import_module(
        "benchmark." + bench.traffic(cell["traffic"])["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        res = drive.run(bench, cell, seed, args.seconds, False, "cuda",
                        control=True)
        _, control_correct = core.judge(res["control"],
                                        bench.limits(cell["name"]))
        print(json.dumps({
            "workload": cell["name"], "seed": seed,
            "program": {k: v for k, (v, _) in res["checks"].items()},
            "correct": res["correct"],
            "control": res["control"],
            "control_correct": control_correct,
            "limits": {k: lim for k, (_, lim) in res["checks"].items()}}),
            flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    from run import ensure_env

    ensure_env()
    sys.exit(main())
