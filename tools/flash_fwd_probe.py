#!/usr/bin/env python3
"""Probe of the port's flash-attention forward kernel on one Hopper card.

    python3 tools/flash_fwd_probe.py            # build, check, time
    python3 tools/flash_fwd_probe.py --clocks   # + SM clock and power under load

Builds ``moviigen_tpu_torch/csrc/flash_fwd.cu`` alone and prints what ptxas
says about it (registers, spills, any wgmma serialisation remark), holds
the forward and the stats variant against ``flash_attention_stats_plain``
at small ragged shapes (a key mask inside a tile, a batch entry with one
key and one with none, Lq under one tile, Lk under one tile), then times
both at the serving and training shapes of ``chip_smoke.py`` (cases a, b,
e, g, g2) beside the earlier ``mma.sync`` design
(``tools/flash_fwd_mma_sync.cu``), which serves as the yardstick through
the same wrapper: the two take turns over three timing rounds and the
median is kept. Beside that single-call event timing
(``chip_smoke.cuda_ms``, which includes the host's share of a call) it
prints the profiler's device time per call of both designs and of SDPA,
and the host microseconds per call of the kept one. It is the quick loop
for work on the kernel: a variant is an edit of the source (or a copy of
it added to ``BUILDS``) followed by this script; ``chip_smoke.py`` phase 2
stays the reading of record.
"""

import json
import pathlib
import statistics
import sys
import time

import torch
from torch.autograd import DeviceType

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from moviigen_tpu_torch import kernels  # noqa: E402
from moviigen_tpu_torch.ops import flash_attention as fa  # noqa: E402

SOURCE = kernels.CSRC / "flash_fwd.cu"
# (label, source): the kept design first
BUILDS = [("kept", SOURCE), ("mma_sync", cs.FWD_BEFORE_SOURCE)]
ROUNDS = 3  # timing rounds, the builds taking turns within each
CLOCKS = ("a_self_B2_L7800", "g_stats_self_B1_L32760")
# (B, Lq, Lk, heads, k_lens); the last two give a block of the persistent
# grid several work items, some of them with no key
SMALL = [(1, 64, 1, 8, None), (1, 64, 3, 8, None), (1, 128, 128, 2, None),
         (2, 130, 70, 8, (70, 1)), (1, 40, 200, 8, None),
         (2, 777, 512, 8, None), (1, 5000, 512, 8, None),
         (2, 1000, 1000, 8, (1000, 600)), (2, 1000, 1000, 8, (1000, 0)),
         (1, 300, 1300, 4, (1200,)), (2, 2000, 1000, 8, (1000, 0)),
         (2, 1500, 700, 16, (700, 333))]
# (name, stats, B, Lq, Lk, heads)
TIMED = [("a_self_B2_L7800", False, 2, 7800, 7800, 40),
         ("b_cross_B2_Lq7800_Lk512", False, 2, 7800, 512, 40),
         ("e_self_B1_L32760", False, 1, 32760, 32760, 40),
         ("g_stats_self_B1_L32760", True, 1, 32760, 32760, 12),
         ("g2_stats_cross_B1_Lq32760_Lk512", True, 1, 32760, 512, 12)]


def ptxas_lines(label):
    for line in kernels.BUILD_LOG.get(label, "").splitlines():
        if any(w in line for w in ("registers", "spill", "warning", "(C75")):
            print(f"  ptxas[{label}]:", line.strip()[:240], flush=True)


def operands(b, lq, lk, n, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(b, l, n, 128, generator=gen, device="cuda",
                        dtype=torch.bfloat16) for l in (lq, lk, lk)]


def run(stats, q, k, v, kl=None):
    if stats:
        return fa.flash_attention_stats_cuda(q, k, v, kl)
    return (fa.flash_attention_cuda(q, k, v, kl),)


def check(label, name, got, want, k_lens=None):
    """Max relative error over out (and m, l); rows of a batch entry with
    no key must be exactly zero, m = -1e30 and l = 0."""
    errs = {}
    for what, g, w in zip(("out", "m", "l"), got, want):
        if k_lens is not None and 0 in k_lens:
            i = k_lens.index(0)
            zero = {"out": 0.0, "m": -1e30, "l": 0.0}[what]
            sel = g[i]
            if not bool((sel == zero).all()):
                raise RuntimeError(f"{label} {name}: {what} of the entry "
                                   f"with no key is not {zero}")
            keep = [j for j in range(len(k_lens)) if j != i]
            g, w = g[keep], w[keep]
        errs[what] = cs._check(f"{label} {name}", what, g, w,
                               cs.FLASH_REL_TOL)[1]
    return errs


def device_ms(fn, iters=10):
    """Device time per call of ``fn`` (every kernel it launches) from
    torch.profiler: free of the host's share, which single-call event
    timings include."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / iters / 1e3


def host_us(fn, iters=50):
    """Host microseconds per call of ``fn`` while the card works through
    the queue (what a caller pays before the launch)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_fwd_probe: needs a CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    kernels.build([label for label, _ in BUILDS], dict(BUILDS))
    print(f"built {len(BUILDS)} sources in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for label, _ in BUILDS:
        ptxas_lines(label)

    for label, src in BUILDS:
        kernels.use("flash_fwd", src)
        for b, lq, lk, n, k_lens in SMALL:
            q, k, v = operands(b, lq, lk, n)
            kl = None if k_lens is None else torch.tensor(
                k_lens, dtype=torch.int32, device="cuda")
            want = fa.flash_attention_stats_plain(q, k, v, kl)
            name = f"B{b}_Lq{lq}_Lk{lk}_N{n}_klens{k_lens}"
            errs = check(label, name, run(True, q, k, v, kl), want, k_lens)
            errs["fwd_out"] = check(label, name, run(False, q, k, v, kl),
                                    want[:1], k_lens)["out"]
            if label == "kept":
                print(json.dumps(dict(case=name, rel_err=errs)), flush=True)
        print(f"{label}: {len(SMALL)} small shapes pass", flush=True)

    for name, stats, b, lq, lk, n in TIMED:
        q, k, v = operands(b, lq, lk, n, seed=1)
        want = fa.flash_attention_stats_plain(q, k, v)
        if stats:
            bound, by = cs.train_bounds(b, lq, lk, [lk] * b, n=n)[0]
        else:
            bound, by = cs.flash_bound(b, lq, [lk] * b, n=n)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        row = dict(case=name, bound_ms=bound, bound_by=by,
                   library_ms=cs.cuda_ms(lambda: torch.nn.functional
                                         .scaled_dot_product_attention(
                                             qt, kt, vt)))
        for label, src in BUILDS:
            kernels.use("flash_fwd", src)
            check(label, name, run(stats, q, k, v), want)
        times = {label: [] for label, _ in BUILDS}
        for _ in range(ROUNDS):
            for label, src in BUILDS:
                kernels.use("flash_fwd", src)
                times[label].append(cs.cuda_ms(lambda: run(stats, q, k, v)))
        for label, ms in times.items():
            row[f"{label}_ms"] = statistics.median(ms)
            row[f"{label}_ms_range"] = [min(ms), max(ms)]
        row["kept_bound_share"] = bound / row["kept_ms"]
        for label, src in BUILDS:
            kernels.use("flash_fwd", src)
            row[f"{label}_device_ms"] = device_ms(lambda: run(stats, q, k, v))
        kernels.use("flash_fwd")
        row["kept_host_us"] = host_us(lambda: run(stats, q, k, v))
        row["library_device_ms"] = device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt))
        print(json.dumps(row), flush=True)
        if "--clocks" in sys.argv and name in CLOCKS:
            kernels.use("flash_fwd")
            mhz, watts = cs.clocks_under_load(lambda: run(stats, q, k, v),
                                              row["kept_ms"])
            print(json.dumps({"case": name, "sm_mhz": mhz, "power_w": watts}),
                  flush=True)
        del q, k, v, qt, kt, vt, want
        torch.cuda.empty_cache()
    kernels.use("flash_fwd")
    return 0


if __name__ == "__main__":
    sys.exit(main())
