#!/usr/bin/env python3
"""Probe of the port's flash-attention backward kernels on one Hopper card.

    python3 tools/flash_bwd_probe.py            # build, check, time
    python3 tools/flash_bwd_probe.py --clocks   # + SM clock and power under load

Builds ``moviigen_tpu_torch/csrc/flash_bwd.cu`` alone and prints what ptxas
says about it (registers, spills, any wgmma serialisation remark), holds
dq, dk and dv against ``flash_bwd_plain`` at small ragged shapes, then
times both kernels at the training shapes of ``chip_smoke.py`` (cases h,
i, j, k) and at the t2v-14B cross-attention (B=2, 40 heads). It is the
quick loop for work on the kernels: a variant (ring depth ``kStages``,
warpgroups per block ``kConsumers``, another order of the products) is an
edit of the source followed by this script; ``chip_smoke.py`` phase 2 stays
the reading of record.
"""

import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from moviigen_tpu_torch import kernels  # noqa: E402
from moviigen_tpu_torch.ops import flash_attention as fa  # noqa: E402

# (B, Lq, Lk, heads, k_lens): ragged tiles, a key mask inside a tile, a
# batch entry with one key and one with none, Lq under one tile, a shape
# whose dKV query loop is split
SMALL = [(1, 64, 64, 1, None), (1, 128, 128, 2, None),
         (2, 1000, 1000, 8, None), (2, 777, 512, 8, None),
         (2, 1000, 1000, 8, (1000, 600)), (1, 64, 3, 8, None),
         (2, 130, 70, 8, (70, 1)), (1, 40, 200, 8, None),
         (1, 5000, 512, 8, None), (2, 300, 300, 4, (300, 0))]
TIMED = [("h_self_B1_L32760_N12", 1, 32760, 32760, 12, None),
         ("i_cross_B1_Lq32760_Lk512_N12", 1, 32760, 512, 12, None),
         ("j_klens_B2_L7800_N12", 2, 7800, 7800, 12, (7800, 4680)),
         ("k_cross_B1_Lq7800_Lk512_N12", 1, 7800, 512, 12, None),
         ("cross_B2_Lq7800_Lk512_N40", 2, 7800, 512, 40, None)]


def operands(b, lq, lk, n, k_lens, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, l, n, 128, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for l in (lq, lk, lk))
    kl = None if k_lens is None else torch.tensor(
        k_lens, dtype=torch.int32, device="cuda")
    out, m, l = fa.flash_attention_stats_plain(q, k, v, kl)
    do = torch.randn(out.shape, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    return (q, k, v, kl, out, m, l, do)


def check(name, b, lq, lk, n, k_lens, timed=False):
    args = operands(b, lq, lk, n, k_lens)
    ops = fa.bwd_operands(*args)
    dk, dv = fa.flash_bwd_dkv_cuda(ops)
    dq = fa.flash_bwd_dq_cuda(ops)
    torch.cuda.synchronize()
    want = fa.flash_bwd_plain(*args)
    row = dict(case=name, dkv_query_splits=fa.dkv_query_splits(b, n, lq, lk))
    for what, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        row[what] = cs._check(name, what, got, ref, cs.GRAD_REL_TOL)[1]
    if k_lens is not None:
        for what, got in (("dk", dk), ("dv", dv)):
            for i, klen in enumerate(k_lens):
                if bool(got[i, klen:].any()):
                    raise RuntimeError(f"{name}: {what} non-zero past k_lens")
    if timed:
        row["dkv_ms"] = cs.cuda_ms(lambda: fa.flash_bwd_dkv_cuda(ops))
        row["dq_ms"] = cs.cuda_ms(lambda: fa.flash_bwd_dq_cuda(ops))
    print(json.dumps(row), flush=True)
    return ops, row


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_probe: needs a CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    kernels.build(["flash_bwd"])
    print(f"built flash_bwd in {time.perf_counter() - t0:.1f} s")
    for line in kernels.BUILD_LOG.get("flash_bwd", "").splitlines():
        if any(w in line for w in ("registers", "spill", "warning", "(C75")):
            print("  ptxas:", line.strip()[:240])
    for b, lq, lk, n, k_lens in SMALL:
        check(f"B{b}_Lq{lq}_Lk{lk}_N{n}_klens{k_lens}", b, lq, lk, n, k_lens)
    for name, b, lq, lk, n, k_lens in TIMED:
        ops, row = check(name, b, lq, lk, n, k_lens, timed=True)
        if "--clocks" in sys.argv and name.startswith("h_"):
            for key, fn in (("dkv", fa.flash_bwd_dkv_cuda),
                            ("dq", fa.flash_bwd_dq_cuda)):
                mhz, watts = cs.clocks_under_load(lambda: fn(ops),
                                                  row[f"{key}_ms"])
                print(json.dumps({"kernel": key, "sm_mhz": mhz,
                                  "power_w": watts}), flush=True)
        del ops
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
