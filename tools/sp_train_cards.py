#!/usr/bin/env python3
"""Sequence-parallel fine-tuning across cards: ``cli.finetune`` under
``torchrun``, one rank per card, against the same run on one card.

    python3 tools/sp_train_cards.py                     # 4 cards
    python3 tools/sp_train_cards.py --task t2v-tiny --device cpu \\
        --latent 4,2,8,8                                # 4 gloo ranks

Writes a synthetic latent dataset (``--clips`` clips of ``--latent``
[C, F, H, W], random from ``--seed``) under ``_smoke_out/sp_cards``, then
runs ``cli.finetune --task <task> --gradient_checkpointing`` with a random
DiT for ``--steps`` steps in each layout of ``--layouts``:

- ``one``: one process on one card (no mesh);
- ``sp<N>``: ``--sp_size N`` over N ranks (a (1, N) mesh, Ulysses);
- ``dp<D>sp<N>``: ``--sp_size N`` over D·N ranks (D data-parallel groups,
  so each step takes D items where ``one`` and ``sp<N>`` take 1).

Each layout but ``one`` is one ``torchrun --standalone`` launch (NCCL on
cards, gloo with ``--device cpu``); its rank 0 writes what
``finetune.main`` returned.
Prints one JSON line per layout (the seconds of each step, the median of
steps 2 and on, losses, grad norms, every rank's peak GiB, the final
checkpoint's save seconds and size), then the relative difference of
each ``sp<N>`` run's losses from ``one``'s (same weights, data and noise;
bf16 compute summed in other orders), and last the card's name and power
limit as ``nvidia-smi`` prints them. Fails if a launch fails or a loss is
not finite.
"""

import argparse
import json
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
OUT = ROOT / "_smoke_out" / "sp_cards"


def _dataset(latent, clips, text_dim, seed):
    """A latent set in the reference layout; returns its json."""
    data = OUT / "data"
    for d in (data / "latent", data / "prompt_embed"):
        d.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    annos = []
    for i in range(clips):
        np.save(data / "latent" / f"clip{i}.npy",
                rng.standard_normal(latent, dtype=np.float32))
        np.save(data / "prompt_embed" / f"clip{i}.npy",
                rng.standard_normal((77, text_dim), dtype=np.float32))
        annos.append({"latent_path": f"clip{i}.npy",
                      "prompt_embed_path": f"clip{i}.npy",
                      "length": 4 * (latent[1] - 1) + 1,
                      "aspect_ratio_bin": 0})
    path = data / "videos2caption.json"
    path.write_text(json.dumps(annos))
    return path


def _layout(name):
    """(ranks, sp_size) of a layout name."""
    if name == "one":
        return 1, 1
    if name.startswith("sp"):
        n = int(name[2:])
        return n, n
    d, n = name[2:].split("sp")
    return int(d) * int(n), int(n)


def worker(argv):
    """One rank of a launch: ``finetune.main(argv)`` (which brings the
    process group up from torchrun's variables and down again). Every
    rank writes its peak GiB to ``$SP_CARDS_OUT.rank<r>``; rank 0 also
    writes the record to ``$SP_CARDS_OUT``."""
    import torch

    sys.path.insert(0, str(ROOT))
    from moviigen_tpu_torch.cli import finetune

    rank = int(os.environ.get("RANK", "0"))
    t0 = time.perf_counter()
    record = finetune.main(argv)
    main_s = time.perf_counter() - t0
    out = pathlib.Path(os.environ["SP_CARDS_OUT"])
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if torch.cuda.is_initialized() else 0.0)
    pathlib.Path(f"{out}.rank{rank}").write_text(json.dumps(peak))
    if rank == 0:
        path = pathlib.Path(record["checkpoint"])
        out.write_text(json.dumps(dict(
            step_s=record["step_s"], loss=record["loss"],
            grad_norm=record["grad_norm"], main_s=main_s,
            mesh=None if record["comm"] is None
            else dict(record["comm"].shape),
            checkpoint_save_s=record["checkpoint_s"],
            checkpoint_gib=sum(f.stat().st_size for f in path.iterdir())
            / 2**30)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", default="t2v-1.3B")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layouts", default="one,sp4,dp2sp2")
    ap.add_argument("--latent", default="16,21,60,104",
                    help="C,F,H,W of each clip (default: 32,760 tokens)")
    ap.add_argument("--clips", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds a launch may take")
    args = ap.parse_args()

    sys.path.insert(0, str(ROOT))
    from moviigen_tpu_torch.configs import WAN_CONFIGS

    latent = tuple(int(x) for x in args.latent.split(","))
    shutil.rmtree(OUT, ignore_errors=True)
    data_json = _dataset(latent, args.clips,
                         WAN_CONFIGS[args.task].model.text_dim, args.seed)
    rows = {}
    try:
        for name in args.layouts.split(","):
            ranks, sp = _layout(name)
            out = OUT / f"{name}.json"
            env = dict(os.environ, SP_CARDS_OUT=str(out),
                       OMP_NUM_THREADS="1")
            # one: a plain process, no process group and no mesh
            launch = [sys.executable] if name == "one" else [
                sys.executable, "-m", "torch.distributed.run",
                "--standalone", "--nproc_per_node", str(ranks)]
            cmd = launch + [__file__, "--worker",
                   "--task", args.task, "--device", args.device,
                   "--data_json_path", str(data_json),
                   "--num_latent_t", str(latent[1]),
                   "--gradient_checkpointing",
                   "--max_train_steps", str(args.steps),
                   "--checkpointing_steps", "100000",
                   "--output_dir", str(OUT / name), "--seed",
                   str(args.seed), "--sp_size", str(sp)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, env=env, cwd=ROOT,
                                  timeout=args.timeout, capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-8000:],
                      file=sys.stderr)
                raise SystemExit(f"{name}: torchrun exited "
                                 f"{proc.returncode}")
            row = json.loads(out.read_text())
            row.update(layout=name, ranks=ranks, sp_size=sp,
                       peak_gib=[json.loads(pathlib.Path(
                           f"{out}.rank{r}").read_text())
                           for r in range(ranks)],
                       launch_s=time.perf_counter() - t0,
                       step_s_median=statistics.median(row["step_s"][1:])
                       if len(row["step_s"]) > 1 else row["step_s"][0])
            if not np.isfinite(row["loss"]).all():
                raise SystemExit(f"{name}: loss {row['loss']}")
            rows[name] = row
            print(json.dumps(row), flush=True)
            shutil.rmtree(OUT / name, ignore_errors=True)
    finally:
        shutil.rmtree(OUT, ignore_errors=True)
    if "one" in rows:
        one = np.asarray(rows["one"]["loss"])
        for name, row in rows.items():
            if name.startswith("sp"):
                rel = np.abs(np.asarray(row["loss"]) - one) / np.abs(one)
                print(json.dumps({"layout": name, "vs": "one",
                                  "loss_rel_diff": rel.tolist()}),
                      flush=True)
    if args.device != "cpu":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    if "--worker" in sys.argv:
        worker([a for a in sys.argv[1:] if a != "--worker"])
    else:
        main()
