#!/usr/bin/env python3
"""Device memory of the port's VAE decode against the output pixels it
holds at once, on one CUDA card.

    python3 tools/vae_decode_memory.py
    python3 tools/vae_decode_memory.py --cases 1920*832*81,1280*720*9

Builds the Wan VAE of ``--task`` (random weights from ``--seed``; only the
VAE is on the card) and decodes a random latent for each ``W*H*frames``
case through ``pipelines.text2video.decode_video``, the pipeline's own
decode: one tensor up to ``STREAMING_DECODE_PIXELS`` output pixels,
streaming above. Prints one JSON line per case: the path taken, the
pixels of the clip and ``decode_pixels_at_once``, the pipeline's
estimate ``decode_gib`` (what the rule for parking the DiT reads), the
decode's peak above what was allocated before it
(``torch.cuda.max_memory_allocated``, reset before each case), GiB per
million pixels held at once, and seconds. A case that does not fit is a
line with ``"oom": true``. ``--view_caches`` runs the streaming decode as
it was before its caches were copies: each cache a view of its layer's
whole input, the comparison for the copy's cost. The last lines give the
card's memory and its name and power limit as ``nvidia-smi`` prints
them.
"""

import argparse
import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from moviigen_tpu_torch import kernels  # noqa: E402
from moviigen_tpu_torch.configs import WAN_CONFIGS  # noqa: E402
from moviigen_tpu_torch.models import vae as vaem  # noqa: E402
from moviigen_tpu_torch.models import vae_streaming  # noqa: E402
from moviigen_tpu_torch.pipelines.text2video import (  # noqa: E402
    compute_target_shape_and_seq_len, decode_gib, decode_pixels_at_once,
    decode_streams, decode_video)

# streaming (one chunk held whatever the length), then one-tensor decodes
CASES = ("832*480*81,1280*720*81,1920*832*81,1920*832*33,1920*1072*81,"
         "1280*720*5,832*480*33,1280*720*9,1920*832*5,1920*832*9")


def run_case(params, config, w, h, frames, seed):
    shape, _, _ = compute_target_shape_and_seq_len(config, (w, h), frames)
    latent = torch.randn((1, *shape), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(seed))
    at_once = decode_pixels_at_once(latent.shape, config.vae)
    line = dict(size=f"{w}*{h}", frames=frames, pixels=w * h * frames,
                path="stream" if decode_streams(shape[1], h, w) else "full",
                pixels_at_once=at_once,
                estimate_gib=decode_gib(latent.shape, config.vae))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        video = decode_video(params, latent, config)
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as e:
        line.update(oom=True, error=str(e).splitlines()[0][:200])
        return line
    peak = (torch.cuda.max_memory_allocated() - before) / 2**30
    line.update(oom=False, decode_s=time.perf_counter() - t0,
                peak_above_gib=peak,
                gib_per_mpx_at_once=peak / (at_once / 1e6),
                finite=bool(torch.isfinite(video).all()))
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", default="t2v-14B")
    ap.add_argument("--cases", default=CASES,
                    help="W*H*frames, separated by commas")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--view_caches", action="store_true",
                    help="keep each streaming cache as a view (the earlier "
                         "code), to compare with the copies")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if args.view_caches:
        vae_streaming._CacheIO.put = lambda io, c: io.out.append(c)
    config = WAN_CONFIGS[args.task]
    params = vaem.init_params(config.vae, torch.Generator(device="cuda")
                              .manual_seed(args.seed), device="cuda")
    for case in args.cases.split(","):
        w, h, frames = (int(v) for v in case.split("*"))
        print(json.dumps(run_case(params, config, w, h, frames, args.seed)),
              flush=True)
    _, total = torch.cuda.mem_get_info()
    print(json.dumps(dict(total_gib=total / 2**30,
                          view_caches=args.view_caches,
                          vae_resident_gib=torch.cuda.memory_allocated()
                          / 2**30,
                          decode_dtype=config.vae_decode_dtype)))
    print(kernels.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
