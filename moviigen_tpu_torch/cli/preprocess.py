"""Dataset preprocessing CLI of the PyTorch port: raw videos → VAE latents
+ umT5 prompt embeddings, the caches ``cli/finetune.py`` reads.

Counterpart of ``moviigen_tpu/cli/preprocess.py`` (ref
``scripts/data_preprocess/preprocess_wan_dataset.py``), with the same
flags and outputs: per-video VAE encode and caption encode cached as
``latent/<name>.npy`` (fp32 [z, T', H', W']) and ``prompt_embed/<name>.npy``
(fp32 [true_len, dim]), a resumable ``processed_items_shard<k>.json`` saved
periodically and on SIGINT/SIGTERM (then exiting with 128 + the
signal's number), per-error-type budgets, a
``videos2caption_<run>.json`` merged with the previous run's and its
``videos2caption_latest.json`` symlink, and
``preprocess_stats_shard<k>.json``. Sharding is ``--shard_idx`` /
``--num_shards`` (modulo split).

It runs on ``--device`` (the CUDA card unless told otherwise; ``--device
cpu`` for small configs on the CPU). Clips above
``STREAMING_ENCODE_PIXELS`` input pixels are encoded in chunks of 4
frames (``models/vae_streaming.py::encode_video``), which gives the same
latents. Weights come from ``--model_path`` (a checkpoint directory in
the reference layout) or are random from ``--seed``: the VAE from a
generator seeded with ``seed``, the umT5 from ``seed + 1``, so the split
stages (``cli/preprocess_stages.py``) build the same random models.

Example:
    python -m moviigen_tpu_torch.cli.preprocess \\
        --data_merge_path data/merge.txt --output_dir data/preprocess \\
        --task t2v-14B --model_path ckpts/MoviiGen1.1
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import time
from collections import defaultdict
from datetime import datetime

import numpy as np
import torch


def _parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Preprocess videos into latent/embedding caches "
                    "(PyTorch/CUDA)")
    p.add_argument("--data_merge_path", type=str, required=True)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--task", type=str, default="t2v-14B")
    p.add_argument("--dataset", type=str, default="t2v",
                   choices=["t2v", "i2v"],
                   help="i2v (first-frame conditioning and CLIP features) "
                        "comes with the i2v slice (ROADMAP queue 1 item 10)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card; raises "
                        "without one)")
    p.add_argument("--model_path", type=str, default=None,
                   help="checkpoint dir for VAE/T5 (random if unset)")
    p.add_argument("--num_frames", type=int, default=81)
    p.add_argument("--train_fps", type=int, default=16)
    p.add_argument("--max_height", type=int, default=1080)
    p.add_argument("--max_width", type=int, default=1920)
    p.add_argument("--crop_height", type=int, default=None,
                   help="override: single crop size for all aspect bins")
    p.add_argument("--crop_width", type=int, default=None)
    p.add_argument("--drop_short_ratio", type=float, default=1.0)
    p.add_argument("--video_length_tolerance_range", type=float,
                   default=2.0)
    p.add_argument("--shard_idx", type=int, default=0)
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("--max_errors_per_type", type=int, default=100)
    p.add_argument("--checkpoint_interval_sec", type=int, default=300)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--encode_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="VAE encode compute dtype (ref preprocesses bf16)")
    return p.parse_args(argv)


# ------------------------------------------------ shared with the stages


def load_vae(args, cfg, device):
    """The VAE tree with its encoder: from ``--model_path`` or random from
    ``--seed``."""
    from ..models import vae as vaem
    from ..models.vae_convert import load_vae_checkpoint

    if args.model_path:
        return load_vae_checkpoint(
            os.path.join(args.model_path, cfg.vae_checkpoint), cfg.vae,
            torch.float32, device)
    logging.warning("random-init VAE (no --model_path)")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    return vaem.init_params(cfg.vae, gen, device=device, encoder=True)


def load_t5(args, cfg, device):
    """(umT5 encoder in the config's T5 dtype, tokenizer): from
    ``--model_path`` or random from ``--seed`` + 1."""
    from ..models.t5 import T5Encoder, load_t5_checkpoint
    from ..models.tokenizer import load_tokenizer

    dtype = getattr(torch, cfg.t5_dtype)
    if args.model_path:
        t5 = load_t5_checkpoint(
            os.path.join(args.model_path, cfg.t5_checkpoint), cfg.t5,
            dtype, device)
        tok_path = os.path.join(args.model_path, cfg.t5_tokenizer)
    else:
        logging.warning("random-init T5 (no --model_path)")
        gen = torch.Generator(device=device).manual_seed(args.seed + 1)
        t5 = T5Encoder(cfg.t5, dtype=dtype, device=device).init_weights(gen)
        tok_path = cfg.t5_tokenizer
    tokenizer = load_tokenizer(tok_path, seq_len=cfg.model.text_len,
                               vocab_size=cfg.t5.vocab_size)
    return t5.eval(), tokenizer


def make_dataset(args):
    from ..data.t2v_dataset import T2VDataset

    bin_crop_sizes = None
    if args.crop_height and args.crop_width:
        bin_crop_sizes = [
            {"height": args.crop_height, "width": args.crop_width}] * 3
    return T2VDataset(
        args.data_merge_path, num_frames=args.num_frames,
        train_fps=args.train_fps, max_height=args.max_height,
        max_width=args.max_width, drop_short_ratio=args.drop_short_ratio,
        video_length_tolerance_range=args.video_length_tolerance_range,
        bin_crop_sizes=bin_crop_sizes, seed=args.seed)


@torch.no_grad()
def encode_latent(vae_params, pixel_values: np.ndarray, cfg, dtype,
                  device) -> np.ndarray:
    """[3, T, H, W] in [-1, 1] → fp32 normalized latents [z, T', H', W'],
    encoded in ``dtype``."""
    from ..models.vae_streaming import encode_video

    video = torch.from_numpy(pixel_values[None]).to(device).to(dtype)
    return encode_video(vae_params, video, cfg.vae)[0].float().cpu().numpy()


@torch.no_grad()
def encode_text(t5, tokenizer, text: str, device) -> np.ndarray:
    """A caption → fp32 embeddings [true_len, dim]."""
    ids, mask = tokenizer([text], return_mask=True)
    ctx = t5(torch.as_tensor(np.asarray(ids), dtype=torch.long,
                             device=device),
             torch.as_tensor(np.asarray(mask), dtype=torch.long,
                             device=device))
    return ctx[0, :int(mask[0].sum())].float().cpu().numpy()


# ------------------------------------------------------------------ main


def main(argv=None):
    """Run the preprocessing; returns the path of the run's merged
    ``videos2caption_<run>.json``."""
    args = _parse_args(argv)
    if args.dataset == "i2v":
        raise NotImplementedError(
            "--dataset i2v is not supported by the PyTorch port yet; it "
            "comes with the i2v slice (ROADMAP queue 1 item 10)")
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s] %(levelname)s: %(message)s")

    from ..pipelines.text2video import resolve_device

    device = resolve_device(args.device)
    os.makedirs(os.path.join(args.output_dir, "latent"), exist_ok=True)
    os.makedirs(os.path.join(args.output_dir, "prompt_embed"), exist_ok=True)

    # resumable processed set (ref preprocess_wan_dataset.py:100-135)
    processed_path = os.path.join(
        args.output_dir, f"processed_items_shard{args.shard_idx}.json")
    processed = set()
    if os.path.exists(processed_path):
        with open(processed_path) as f:
            processed = set(json.load(f))
        logging.info("resuming: %d items already processed", len(processed))

    def save_processed():
        with open(processed_path, "w") as f:
            json.dump(sorted(processed), f)

    def handler(signum, frame):
        # exits with the shell's code for a signal (JAX exits 0), so a
        # caller does not read an interrupted run as a finished one
        logging.info("signal %d: saving processed set", signum)
        save_processed()
        sys.exit(128 + signum)

    prev_int = signal.signal(signal.SIGINT, handler)
    prev_term = signal.signal(signal.SIGTERM, handler)
    try:
        return _run(args, device, processed, save_processed)
    finally:
        signal.signal(signal.SIGINT, prev_int)
        signal.signal(signal.SIGTERM, prev_term)


def _run(args, device, processed, save_processed):
    from ..configs import WAN_CONFIGS

    cfg = WAN_CONFIGS[args.task]
    latent_dir = os.path.join(args.output_dir, "latent")
    embed_dir = os.path.join(args.output_dir, "prompt_embed")
    cuda = device.type == "cuda"

    vae_params = load_vae(args, cfg, device)
    t5, tokenizer = load_t5(args, cfg, device)
    enc_dt = getattr(torch, args.encode_dtype)
    dataset = make_dataset(args)

    error_counts = defaultdict(int)
    metadata_items = []
    # per processed item: seconds of the VAE encode and of the T5 encode,
    # and (on the card) the peak GiB allocated during the VAE encode
    timings = {"vae_s": [], "t5_s": [], "vae_peak_gib": []}
    last_save = time.time()

    for idx in range(len(dataset)):
        if idx % args.num_shards != args.shard_idx:
            continue
        item_key = dataset.cap_list[idx]["path"]
        name = os.path.splitext(os.path.basename(item_key))[0] + f"_{idx}"
        if item_key in processed:
            continue
        try:
            sample = dataset[idx]
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            latent = encode_latent(vae_params, sample["pixel_values"], cfg,
                                   enc_dt, device)
            vae_s = time.perf_counter() - t0
            vae_peak = torch.cuda.max_memory_allocated(device) / 2**30 \
                if cuda else None
            np.save(os.path.join(latent_dir, f"{name}.npy"), latent)

            t0 = time.perf_counter()
            emb = encode_text(t5, tokenizer, sample["text"], device)
            t5_s = time.perf_counter() - t0
            np.save(os.path.join(embed_dir, f"{name}.npy"), emb)

            metadata_items.append({
                "latent_path": f"{name}.npy",
                "prompt_embed_path": f"{name}.npy",
                "caption": sample["text"],
                "length": int(latent.shape[1]),
                "aspect_ratio_bin":
                    sample["metadata"]["aspect_ratio_bin"],
            })
            processed.add(item_key)
            timings["vae_s"].append(vae_s)
            timings["t5_s"].append(t5_s)
            timings["vae_peak_gib"].append(vae_peak)
        except Exception as e:  # per-item fault tolerance (ref L556-567)
            etype = type(e).__name__
            error_counts[etype] += 1
            logging.warning("item %s failed (%s): %s", item_key, etype, e,
                            exc_info=True)
            if error_counts[etype] > args.max_errors_per_type:
                logging.error("too many %s errors; aborting", etype)
                break
        if time.time() - last_save > args.checkpoint_interval_sec:
            save_processed()
            last_save = time.time()

    save_processed()

    # merged annotation json + _latest symlink (ref L612-664); a resumed
    # run merges with the previous run's metadata so _latest stays the
    # full dataset view
    run_tag = datetime.now().strftime("%Y%m%d_%H%M%S")
    out_json = os.path.join(args.output_dir,
                            f"videos2caption_{run_tag}.json")
    latest = os.path.join(args.output_dir, "videos2caption_latest.json")
    if os.path.exists(latest):
        try:
            with open(latest) as f:
                old = json.load(f)
            seen = {m["latent_path"] for m in metadata_items}
            metadata_items = [m for m in old
                              if m["latent_path"] not in seen] \
                + metadata_items
        except (OSError, ValueError, KeyError, TypeError) as e:
            logging.warning("could not merge previous metadata: %s", e)
    with open(out_json, "w") as f:
        json.dump(metadata_items, f, indent=1)
    if os.path.islink(latest) or os.path.exists(latest):
        os.remove(latest)
    os.symlink(os.path.basename(out_json), latest)

    stats = {"processed": len(processed), "errors": dict(error_counts),
             "device": str(device),
             "encode_dtype": args.encode_dtype, **timings}
    with open(os.path.join(
            args.output_dir,
            f"preprocess_stats_shard{args.shard_idx}.json"), "w") as f:
        json.dump(stats, f)
    logging.info("preprocessing done: %s", stats)
    return out_json


if __name__ == "__main__":
    main()
