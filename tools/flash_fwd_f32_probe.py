#!/usr/bin/env python3
"""Probe of the fp32 flash forward (``csrc/flash_fwd_f32.cu``, the CLIP
tower's attention) on one Hopper card.

    python3 tools/flash_fwd_f32_probe.py              # build, check, time
    python3 tools/flash_fwd_f32_probe.py --variants   # + patched copies
    python3 tools/flash_fwd_f32_probe.py --extra=label=path.cu  # + a source

Builds the kernel (and with ``--variants`` patched copies of its source:
other block shapes and tile sizes, the small half rounded,
one TF32 pass, timing floors) beside its
first design (``tools/flash_fwd_f32_simple.cu``) and prints what ptxas
says about each (registers, spills). Holds each against the plain twin at
edge shapes, measures each one's error and the twin's against a float64
evaluation of the same function with q scaled x1, x4 and x8 (the gate
that decides 3xTF32 against fp32 FMAs), then times all of them at
``chip_smoke.py``'s two fp32 cases in turns: device times of single calls
queued behind a spin of the card (``chip_smoke.device_times``), the
profiler's device time as a cross-check, SDPA in fp32 and the plain twin
beside them. ``chip_smoke.py`` phase 2 stays the reading of record.
"""

import json
import pathlib
import re
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

SOURCE = kernels.CSRC / "flash_fwd_f32.cu"
ROW_WARPS = "constexpr int kRowWarps = 2;"
KEY_WARPS = "constexpr int kKeyWarps = 2;"
KEYS = "constexpr int kKeys = 64;"
STAGES = "constexpr int kStages = 2;"
STAGES_3 = "constexpr int kStages = 3;"
STAGES_4 = "constexpr int kStages = 4;"
# label: [(text in the kept source, its replacement), ...]; "rXkYsZ" is
# X query rows a block (16 per row warp), Y key warps, Z keys a tile
VARIANTS = {
    "r16k4s32": [(ROW_WARPS, "constexpr int kRowWarps = 1;"),
                 (KEY_WARPS, "constexpr int kKeyWarps = 4;"),
                 (KEYS, "constexpr int kKeys = 32;")],
    "r32k2s32": [(KEYS, "constexpr int kKeys = 32;")],
    "r64k2s64": [(ROW_WARPS, "constexpr int kRowWarps = 4;")],
    "r32k1s64": [(KEY_WARPS, "constexpr int kKeyWarps = 1;")],
    # deeper rings: more tiles in flight
    "r32k2s32x3": [(KEYS, "constexpr int kKeys = 32;"), (STAGES, STAGES_3)],
    "r32k2s32x4": [(KEYS, "constexpr int kKeys = 32;"), (STAGES, STAGES_4)],
    "r64k2s32x4": [(ROW_WARPS, "constexpr int kRowWarps = 4;"),
                   (KEYS, "constexpr int kKeys = 32;"), (STAGES, STAGES_4)],
    "r64k2s64x3": [(ROW_WARPS, "constexpr int kRowWarps = 4;"),
                   (STAGES, STAGES_3)],
    "r64k4s32x4": [(ROW_WARPS, "constexpr int kRowWarps = 4;"),
                   (KEY_WARPS, "constexpr int kKeyWarps = 4;"),
                   (KEYS, "constexpr int kKeys = 32;"), (STAGES, STAGES_4)],
    # small rounded to nearest as well (two more integer ops a value)
    "rna_small": [("  small = __float_as_uint(x - __uint_as_float(big));",
                   "  small = tf32_rna(x - __uint_as_float(big));")],
    # one TF32 pass in S: what the precision gate must catch
    "tf32x1": [("        mma(ss[n], qs, bb0, bb1);\n"
                "        mma(ss[n], qb, bs0, bs1);\n", "")],
    # timing floors, wrong by design: no products (launch, ring, merge,
    # store), and only the first tile loaded (the products alone)
    "loads_only": [("      slice_step<kD, true>(sk, sv, qf, nv, lane, o, m, l);",
                    "      m[0] += sk[0] + sv[0];"),
                   ("      slice_step<kD, false>(sk, sv, qf, nv, lane, o, m, l);",
                    "      m[1] += sk[0];")],
    "loads_only_r64": [(ROW_WARPS, "constexpr int kRowWarps = 4;"),
                       ("      slice_step<kD, true>(sk, sv, qf, nv, lane, o, m, l);",
                        "      m[0] += sk[0] + sv[0];"),
                       ("      slice_step<kD, false>(sk, sv, qf, nv, lane, o, m, l);",
                        "      m[1] += sk[0];")],
    "compute_only": [("    if (tile + kStages - 1 < tiles) load_tile(tile + kStages - 1);",
                      "")],
}
# builds whose output is wrong by design: checked only to be caught
WRONG = ("tf32x1", "loads_only", "loads_only_r64", "compute_only")
# (B, Lq, Lk, N, D, k_lens)
SHAPES = [(1, 1, 257, 2, 80, None), (1, 17, 1, 2, 80, None),
          (2, 33, 257, 2, 80, (257, 1)), (3, 40, 130, 2, 64, (0, 64, 65)),
          (1, 33, 257, 3, 8, None), (2, 17, 257, 2, 128, (65, 257)),
          (1, 257, 257, 16, 80, None), (2, 200, 257, 16, 80, (257, 130))]
ROUNDS = 2  # timing rounds, forwards then backwards through the builds
LOG2E = 1.4426950408889634


def builds(with_variants, extra=()):
    """{label: source}: the kept source, the first design, with
    ``with_variants`` the patched copies, and ``extra`` (label=path)."""
    out = {"kept": SOURCE, "simple": cs.F32_BEFORE_SOURCE}
    for item in extra:
        label, path = item.split("=", 1)
        out[label] = pathlib.Path(path)
    if with_variants:
        vdir = kernels.BUILD_DIR / "variants"
        vdir.mkdir(parents=True, exist_ok=True)
        text = SOURCE.read_text()
        for label, patches in VARIANTS.items():
            patched = text
            for old, new in patches:
                if old not in patched:
                    raise RuntimeError(f"variant {label}: {old!r} not found")
                patched = patched.replace(old, new)
            path = vdir / f"flash_fwd_f32_{label}.cu"
            path.write_text(patched)
            out[label] = path
    return out


def operands(b, lq, lk, n, d, k_lens, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, l, n, d, generator=gen, device="cuda")
               for l in (lq, lk, lk))
    kl = None if k_lens is None else torch.tensor(
        k_lens, dtype=torch.int32, device="cuda")
    return q, k, v, kl


def f64_reference(q, k, v, kl):
    d = q.shape[-1]
    qscale = float(torch.tensor(d ** -0.5 * LOG2E, dtype=torch.float32))
    s = torch.einsum("bqnd,bknd->bnqk", q.double() * qscale, k.double())
    if kl is not None:
        valid = (torch.arange(k.shape[1], device="cuda")[None, :]
                 < kl[:, None])[:, None, None, :]
        s = torch.where(valid, s, torch.full_like(s, -torch.inf))
    p = torch.softmax(s * 0.6931471805599453, dim=-1)
    return torch.einsum("bnqk,bknd->bqnd", p, v.double())


def ptxas_summary(log):
    """{head dim: (registers, spill-store bytes)} of each kernel instance
    in an ``nvcc -Xptxas -v`` log."""
    out, d = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*?Li(\d+)E", line)
        if m:
            d = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and d is not None:
            out.setdefault(d, [None, 0])[1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and d is not None:
            out.setdefault(d, [None, 0])[0] = int(m.group(1))
    return {k: tuple(v) for k, v in sorted(out.items())}


def profiler_ms(fn, iters=20):
    """Device time per call from torch.profiler (every kernel of fn)."""
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


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_fwd_f32_probe: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(kernels.card_line(), flush=True)
    srcs = builds("--variants" in sys.argv,
                  [a.split("--extra=", 1)[1] for a in sys.argv
                   if a.startswith("--extra=")])
    t0 = time.perf_counter()
    secs = kernels.build(list(srcs), srcs)
    print(f"built {secs} in {time.perf_counter() - t0:.1f} s", flush=True)
    for label in srcs:
        print(f"  ptxas[{label}] D: (registers, spill stores): "
              f"{ptxas_summary(kernels.BUILD_LOG.get(label, ''))}",
              flush=True)

    bad = []
    for label, src in srcs.items():
        kernels.use("flash_fwd_f32", src)
        for b, lq, lk, n, d, k_lens in SHAPES:
            q, k, v, kl = operands(b, lq, lk, n, d, k_lens)
            try:
                got = fa.flash_attention_f32_cuda(q, k, v, kl)
            except RuntimeError as e:  # a variant over the shared memory
                bad.append((label, (b, lq, lk, n, d, k_lens), str(e)))
                print(json.dumps(dict(build=label, shape=[b, lq, lk, n, d,
                                                          k_lens],
                                      error=str(e))), flush=True)
                continue
            want = fa.flash_attention_plain(q, k, v, kl)
            torch.cuda.synchronize()
            err, rel = cs.rel_err(got, want)
            zeros_ok = all(bool((got[i] == 0).all())
                           for i, x in enumerate(k_lens or ()) if x == 0)
            ok = bool(torch.isfinite(got).all()) and rel <= cs.F32_REL_TOL \
                and zeros_ok
            if not ok and label not in WRONG:
                bad.append((label, (b, lq, lk, n, d, k_lens), rel))
            print(json.dumps(dict(build=label, shape=[b, lq, lk, n, d,
                                                      k_lens],
                                  rel_err=rel, ok=ok)), flush=True)
        for b, lq, lk, n, d, k_lens in cs_f32_cases():
            for mult in (1.0, 4.0, 8.0):
                q, k, v, kl = operands(b, lq, lk, n, d, k_lens, seed=3)
                q = q * mult
                want = f64_reference(q, k, v, kl)
                kerr = float((fa.flash_attention_f32_cuda(q, k, v, kl)
                              .double() - want).abs().max())
                terr = float((fa.flash_attention_plain(q, k, v, kl).double()
                              - want).abs().max())
                print(json.dumps(dict(
                    build=label, f64_case=[b, lq, lk, k_lens], mult=mult,
                    kernel_err=kerr, twin_err=terr, ratio=kerr / terr,
                    kernel_rel=kerr / float(want.abs().max()))), flush=True)
    kernels.use("flash_fwd_f32")

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for b, lq, lk, n, d, k_lens in cs_f32_cases():
        q, k, v, kl = operands(b, lq, lk, n, d, k_lens, seed=1)

        def kernel():
            return fa.flash_attention_f32_cuda(q, k, v, kl)

        times = {label: [] for label in srcs}
        order = list(srcs)
        for r in range(ROUNDS):
            for label in (order if r % 2 == 0 else order[::-1]):
                kernels.use("flash_fwd_f32", srcs[label])
                times[label] += cs.device_times(kernel, 100)
        row = dict(case=[b, lq, lk, n, d, k_lens])
        for label, ts in times.items():
            row[f"{label}_ms"] = statistics.median(ts)
            row[f"{label}_ms_p10_p90"] = [
                statistics.quantiles(ts, n=10)[0],
                statistics.quantiles(ts, n=10)[-1]]
            kernels.use("flash_fwd_f32", srcs[label])
            row[f"{label}_profiler_ms"] = profiler_ms(kernel)
        kernels.use("flash_fwd_f32")
        row["kept_call_ms"] = cs.cuda_ms(kernel, iters=200, warmup=20)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = None
        if kl is not None:
            mask = (torch.arange(lk, device="cuda")[None, :]
                    < kl[:, None])[:, None, None, :]
        row["sdpa_ms"] = statistics.median(cs.device_times(
            lambda: sdpa(qt, kt, vt, attn_mask=mask), 200))
        row["sdpa_profiler_ms"] = profiler_ms(
            lambda: sdpa(qt, kt, vt, attn_mask=mask))
        row["sdpa_call_ms"] = cs.cuda_ms(
            lambda: sdpa(qt, kt, vt, attn_mask=mask), iters=200, warmup=20)
        row["plain_ms"] = statistics.median(cs.device_times(
            lambda: fa.flash_attention_plain(q, k, v, kl), 100))
        print(json.dumps(row), flush=True)
    if bad:
        print(f"FAILED: {bad}", flush=True)
        return 1
    return 0


def cs_f32_cases():
    return [(b, lq, lk, n, d, lens)
            for _, b, lq, lk, n, d, lens in cs.F32_CASES]


if __name__ == "__main__":
    sys.exit(main())
