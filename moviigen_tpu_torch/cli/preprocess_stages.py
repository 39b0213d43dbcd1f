"""Split-stage preprocessing CLIs of the PyTorch port.

Counterpart of ``moviigen_tpu/cli/preprocess_stages.py`` (ref
``scripts/data_preprocess/preprocess_vae_latents.py``,
``preprocess_text_embeddings.py`` and
``preprocess_validation_text_embeddings.py``): a VAE-only pass →
``videos2caption_temp.json``, a T5 pass over that json →
``videos2caption.json``, and the validation prompts. The models, the
dataset and the encodes are those of ``cli/preprocess.py``, so the two
stages write what the one-pass CLI writes (at the stages' bf16 encode).

Usage:
    python -m moviigen_tpu_torch.cli.preprocess_stages vae --data_merge_path ...
    python -m moviigen_tpu_torch.cli.preprocess_stages text --json_path ...
    python -m moviigen_tpu_torch.cli.preprocess_stages validation --prompt_dir ...
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os

import numpy as np
import torch

from .preprocess import (encode_latent, encode_text, load_t5, load_vae,
                         make_dataset)


def _common(p):
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--task", type=str, default="t2v-14B")
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card; raises "
                        "without one)")


def _parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Split-stage preprocessing (PyTorch/CUDA)")
    sub = ap.add_subparsers(dest="stage", required=True)

    pv = sub.add_parser("vae", help="VAE latents only")
    _common(pv)
    pv.add_argument("--data_merge_path", type=str, required=True)
    pv.add_argument("--num_frames", type=int, default=81)
    pv.add_argument("--train_fps", type=int, default=16)
    pv.add_argument("--max_height", type=int, default=1080)
    pv.add_argument("--max_width", type=int, default=1920)
    pv.add_argument("--crop_height", type=int, default=None)
    pv.add_argument("--crop_width", type=int, default=None)
    pv.add_argument("--drop_short_ratio", type=float, default=1.0)
    pv.add_argument("--video_length_tolerance_range", type=float,
                    default=2.0)

    pt = sub.add_parser("text", help="T5 embeddings over a latent json")
    _common(pt)
    pt.add_argument("--json_path", type=str, required=True,
                    help="videos2caption_temp.json from the vae stage")
    pt.add_argument("--pad_to", type=int, default=0,
                    help="pad embeddings to this length (ref pads to 256)")

    pp = sub.add_parser("validation", help="encode validation prompts")
    _common(pp)
    pp.add_argument("--prompt_dir", type=str,
                    default="assets/valid_data_t2v")
    return ap.parse_args(argv)


def stage_vae(args, cfg, device):
    os.makedirs(os.path.join(args.output_dir, "latent"), exist_ok=True)
    vae_params = load_vae(args, cfg, device)
    dataset = make_dataset(args)
    items = []
    for idx in range(len(dataset)):
        sample = dataset[idx]
        name = os.path.splitext(
            os.path.basename(sample["path"]))[0] + f"_{idx}"
        # bf16 encode like the reference preprocessing autocast
        latent = encode_latent(vae_params, sample["pixel_values"], cfg,
                               torch.bfloat16, device)
        np.save(os.path.join(args.output_dir, "latent", f"{name}.npy"),
                latent)
        items.append({
            "latent_path": f"{name}.npy",
            "caption": sample["text"],
            "length": int(latent.shape[1]),
            "aspect_ratio_bin": sample["metadata"]["aspect_ratio_bin"],
        })
    out = os.path.join(args.output_dir, "videos2caption_temp.json")
    with open(out, "w") as f:
        json.dump(items, f, indent=1)
    logging.info("vae stage: %d items → %s", len(items), out)
    return out


def stage_text(args, cfg, device):
    t5, tokenizer = load_t5(args, cfg, device)
    os.makedirs(os.path.join(args.output_dir, "prompt_embed"),
                exist_ok=True)
    with open(args.json_path) as f:
        items = json.load(f)
    for item in items:
        name = os.path.splitext(item["latent_path"])[0]
        emb = encode_text(t5, tokenizer, item["caption"], device)
        if args.pad_to and emb.shape[0] < args.pad_to:
            emb = np.concatenate(
                [emb, np.zeros((args.pad_to - emb.shape[0],
                                emb.shape[1]), emb.dtype)])
        np.save(os.path.join(args.output_dir, "prompt_embed",
                             f"{name}.npy"), emb)
        item["prompt_embed_path"] = f"{name}.npy"
    out = os.path.join(args.output_dir, "videos2caption.json")
    with open(out, "w") as f:
        json.dump(items, f, indent=1)
    logging.info("text stage: %d items → %s", len(items), out)
    return out


def stage_validation(args, cfg, device):
    t5, tokenizer = load_t5(args, cfg, device)
    out_dir = os.path.join(args.output_dir, "validation_embed")
    os.makedirs(out_dir, exist_ok=True)
    for path in sorted(glob.glob(os.path.join(args.prompt_dir, "*.txt"))):
        with open(path) as f:
            text = f.read().strip()
        name = os.path.splitext(os.path.basename(path))[0]
        np.save(os.path.join(out_dir, f"{name}.npy"),
                encode_text(t5, tokenizer, text, device))
    logging.info("validation embeddings → %s", out_dir)
    return out_dir


STAGES = {"vae": stage_vae, "text": stage_text,
          "validation": stage_validation}


def main(argv=None):
    """Run one stage; returns the path it wrote (a json, or the
    validation embeddings' directory)."""
    args = _parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s] %(levelname)s: %(message)s")

    from ..configs import WAN_CONFIGS
    from ..pipelines.text2video import resolve_device

    device = resolve_device(args.device)
    return STAGES[args.stage](args, WAN_CONFIGS[args.task], device)


if __name__ == "__main__":
    main()
