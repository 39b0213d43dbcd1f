#!/usr/bin/env python3
"""Probe of the port's W8A8 kernels on one Hopper card: the int8 GEMM
(``moviigen_tpu_torch/csrc/int8_gemm.cu``) and the activation quantization
(``csrc/quantize_act.cu``).

    python3 tools/int8_gemm_probe.py              # build, check, time
    python3 tools/int8_gemm_probe.py --check      # build and check only
    python3 tools/int8_gemm_probe.py --variants   # + the GEMM's switches
    python3 tools/int8_gemm_probe.py --clocks     # + SM clock and power

Builds both kernels and the GEMM's earlier ``mma.sync`` design
(``tools/int8_gemm_mma_sync.cu``, the yardstick, called through the same
wrapper) and prints what ptxas says about each (registers, spills, any
wgmma serialisation remark). Holds the GEMM against ``int8_gemm_plain``
bit for bit at small ragged shapes (M, N and K tails, K under one
128-byte slice) in all three bias modes and both output types, and the
quantization against ``quantize_activations_plain`` on rows built to hit
exact .5 ties, all-zero rows and one-spike rows. Then times the GEMM at
``chip_smoke.INT8_CASES``: the kept build, the yardstick, the library's
``torch._int_mm`` + eager rescale, and with ``--variants`` patched copies
of the kept source (``VARIANTS``: one tile width for every shape,
shallower rings, stores straight from registers); the builds take turns
over three rounds and the median is kept. ``chip_smoke.py`` phase 2 stays
the reading of record.
"""

import argparse
import json
import pathlib
import statistics
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from moviigen_tpu_torch import kernels  # noqa: E402
from tools.flash_fwd_probe import device_ms  # noqa: E402
from moviigen_tpu_torch.ops import int8_gemm as ig  # noqa: E402
from moviigen_tpu_torch.ops import quantization as tq  # noqa: E402

SOURCE = kernels.CSRC / "int8_gemm.cu"
VARIANT_DIR = kernels.BUILD_DIR / "variants"
# the kept source's text -> a variant's: one tile width for every shape,
# a ring depth, or the epilogue's stores straight from the wgmma fragments
# (4 or 8 bytes a thread) instead of staged 16-byte rows
NARROW_FN = "bool narrow_tiles(const Params& p, int sms) {\n"
WIDE_ONLY = (NARROW_FN, NARROW_FN + "  return false;\n")
NARROW_ONLY = (NARROW_FN, NARROW_FN + "  return true;\n")
STORE_FROM = "  Out* out = static_cast<Out*>(p.out);\n"
STORE_TO = "}\n\ntemplate <typename Out, int kBN>\n__global__"
DIRECT_STORE = STORE_FROM + """\
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = n0 + j * 8 + t * 2;
    if (col >= p.n) continue;  // N is a multiple of 8: col + 1 < N too
    const float2 sw = *reinterpret_cast<const float2*>(p.sw + col);
    float2 b = make_float2(0.f, 0.f);
    if (mode != 0) b = *reinterpret_cast<const float2*>(p.bias + col);
    if (r0 < p.m)
      Epi<Out>::store2(out + static_cast<long long>(r0) * p.n + col,
                       Epi<Out>::apply(acc[j][0], sx0, sw.x, b.x, mode),
                       Epi<Out>::apply(acc[j][1], sx0, sw.y, b.y, mode));
    if (r1 < p.m)
      Epi<Out>::store2(out + static_cast<long long>(r1) * p.n + col,
                       Epi<Out>::apply(acc[j][2], sx1, sw.x, b.x, mode),
                       Epi<Out>::apply(acc[j][3], sx1, sw.y, b.y, mode));
  }
"""
VARIANTS = {
    "wide_only": [WIDE_ONLY],
    "narrow_only": [NARROW_ONLY],
    "wide_stages3": [WIDE_ONLY, ("kStagesWide = 4;", "kStagesWide = 3;")],
    "narrow_stages4": [NARROW_ONLY,
                       ("kStagesNarrow = 6;", "kStagesNarrow = 4;")],
    "direct_store": [(STORE_FROM, None)],
}
ROUNDS = 3
# (M, K, N): every tail at once and one at a time; the last two take the
# wide tiles (enough of them for several rounds of the persistent grid)
SMALL = [(1, 16, 8), (63, 48, 136), (64, 144, 264), (65, 5120, 8),
         (129, 48, 5120), (333, 144, 136), (1024, 16, 264), (7, 13824, 24),
         (300, 1024, 520), (4200, 144, 5120), (2000, 48, 13832)]


def ptxas_lines(label):
    for line in kernels.BUILD_LOG.get(label, "").splitlines():
        if any(w in line for w in ("registers", "spill", "warning", "(C75")):
            print(f"  ptxas[{label}]:", line.strip()[:240], flush=True)


def variant_source(label, patches):
    """A copy of the kept source with ``patches`` applied (each text must
    occur once; a replacement of None swaps the epilogue's staged store
    for ``DIRECT_STORE``). The copy holds the whole text, so the build's
    hash follows every edit of the kept source."""
    text = SOURCE.read_text().replace(
        '#include "flash_common.cuh"',
        f'#include "{kernels.CSRC / "flash_common.cuh"}"')
    for old, new in patches:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {label}: {old!r} is not in "
                               f"{SOURCE.name} exactly once")
        if new is None:
            start = text.index(old)
            text = text[:start] + DIRECT_STORE + text[text.index(STORE_TO,
                                                                  start):]
        else:
            text = text.replace(old, new)
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    path = VARIANT_DIR / f"int8_gemm_{label}.cu"
    path.write_text(text)
    return path


def gemm_operands(m, k, n, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                       dtype=torch.int8)
    sx = torch.rand(m, generator=gen, device="cuda") * 0.05 + 1e-3
    sw = torch.rand(n, generator=gen, device="cuda") * 0.01 + 1e-4
    bias = torch.randn(n, generator=gen, device="cuda", dtype=torch.bfloat16)
    return xq, wq, sx, sw, bias


def check_gemm(label):
    """Bit equality with the plain version at the small ragged shapes in
    all three bias modes and both output types."""
    bad = []
    for m, k, n in SMALL:
        xq, wq, sx, sw, bias = gemm_operands(m, k, n)
        for out_dtype in (torch.bfloat16, torch.float32):
            for b, after in ((None, False), (bias, False), (bias, True)):
                got = ig.int8_gemm_cuda(xq, wq, sx, sw, b, out_dtype, after)
                want = ig.int8_gemm_plain(xq, wq, sx, sw, b, out_dtype, after)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    err = float((got.float() - want.float()).abs().max())
                    bad.append(((m, k, n), str(out_dtype), b is not None,
                                after, err))
    print(f"check[{label}]: {len(SMALL) * 6 - len(bad)} of {len(SMALL) * 6} "
          f"bit-equal; differing: {bad[:8]}", flush=True)
    return not bad


def hard_rows(m, k, dtype, seed=0):
    """Random rows, with every fourth row built so that x / sx lands on
    exact .5 ties, every fifth all zero and every seventh one spike."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, k, generator=gen, device="cuda")
    # absmax 127 * 2^e makes sx = 2^e exactly, so x = (c + 0.5) * 2^e
    # divides to the tie c + 0.5 (exact in bf16 too)
    step = 2.0 ** torch.randint(-6, 3, (m, 1), generator=gen, device="cuda")
    codes = torch.randint(-126, 126, (m, k), generator=gen, device="cuda")
    ties = (codes + 0.5) * step
    ties[:, 0] = 127.0 * step[:, 0]
    rows = torch.arange(m, device="cuda")[:, None]
    x = torch.where(rows % 4 == 0, ties, x)
    x = torch.where(rows % 5 == 0, torch.zeros_like(x), x)
    spike = torch.zeros_like(x)
    spike[:, k // 3] = 37.0
    x = torch.where(rows % 7 == 0, spike, x)
    return x.to(dtype)


def check_quant():
    bad = []
    for m, k in ((1, 16), (37, 5120), (300, 13824), (64, 48), (5, 136)):
        for dtype in (torch.bfloat16, torch.float32):
            x = hard_rows(m, k, dtype)
            gq, gs = tq.quantize_activations_cuda(x)
            wq, ws = tq.quantize_activations_plain(x)
            torch.cuda.synchronize()
            if not (torch.equal(gq, wq) and torch.equal(gs, ws)):
                bad.append(((m, k), str(dtype),
                            int((gq != wq).sum()), int((gs != ws).sum())))
    print(f"check[quantize_act]: differing {bad}", flush=True)
    return not bad


def time_cases(builds, clocks):
    """Single-call event timings of every build in turns (the medians of
    ``ROUNDS``), beside the library's route, the bound and, for the kept
    build and the library, the device-only time from the profiler (free
    of the host's share of a call)."""
    for i, (name, m, k, n) in enumerate(cs.INT8_CASES):
        xq, wq, sx, sw, bias = gemm_operands(m, k, n, seed=200 + i)

        def kernel():
            return ig.int8_gemm_cuda(xq, wq, sx, sw, bias, torch.bfloat16,
                                     True)

        times = {label: [] for label, _ in builds}
        for _ in range(ROUNDS):
            for label, src in builds:
                kernels.use("int8_gemm", src)
                times[label].append(cs.cuda_ms(kernel))
        kernels.use("int8_gemm")
        wt, sx2 = wq.t(), sx[:, None]

        def library():
            return (torch._int_mm(xq, wt).float() * sx2 * sw[None, :]).to(
                torch.bfloat16)

        bound, _ = cs._bound(2.0 * m * n * k,
                             m * k + n * k + 2 * m * n + 4 * (m + 2 * n),
                             cs.PEAK_INT8_OPS)
        row = dict(case=name, bound_ms=bound, library_ms=cs.cuda_ms(library),
                   kept_device_ms=device_ms(kernel),
                   library_device_ms=device_ms(library),
                   **{label: statistics.median(t)
                      for label, t in times.items()})
        row["kept_share_of_bound"] = bound / row["kept"]
        if clocks and name.startswith("b_"):
            row["sm_mhz"], row["power_w"] = cs.clocks_under_load(
                kernel, row["kept"])
        print("time " + json.dumps(row), flush=True)
        del xq, wq
        torch.cuda.empty_cache()
    for i, (m, k) in enumerate(cs.QUANT_CASES):
        gen = torch.Generator(device="cuda").manual_seed(i)
        x = torch.randn(m, k, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        row = dict(case=f"quantize_M{m}_K{k}",
                   ms=cs.cuda_ms(lambda: tq.quantize_activations_cuda(x)),
                   device_ms=device_ms(lambda: tq.quantize_activations_cuda(x)),
                   plain_ms=cs.cuda_ms(
                       lambda: tq.quantize_activations_plain(x), iters=5),
                   bound_ms=(3 * m * k + 4 * m) / cs.PEAK_HBM_BYTES * 1e3)
        print("time " + json.dumps(row), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="build and check only")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--clocks", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("int8_gemm_probe: no CUDA device", file=sys.stderr)
        return 2
    print(kernels.card_line(), flush=True)
    builds = [("kept", SOURCE), ("mma_sync", cs.GEMM_BEFORE_SOURCE)]
    if args.variants:
        builds += [(label, variant_source(label, patches))
                   for label, patches in VARIANTS.items()]
    # one nvcc per source, all started together
    secs = kernels.build(["quantize_act"] + [label for label, _ in builds],
                         dict(builds))
    print(f"built {secs}", flush=True)
    for label in ["quantize_act"] + [label for label, _ in builds]:
        ptxas_lines(label)
    ok = check_quant()
    for label, src in builds:
        kernels.use("int8_gemm", src)
        ok = check_gemm(label) and ok
    kernels.use("int8_gemm")
    if not ok:
        print("probe: a kernel differs from its plain version", flush=True)
        return 1
    if not args.check:
        time_cases(builds, args.clocks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
