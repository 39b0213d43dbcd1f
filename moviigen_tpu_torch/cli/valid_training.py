"""Continuous validation watcher of the PyTorch port.

Counterpart of ``moviigen_tpu/cli/valid_training.py`` (ref
``scripts/inference/valid_training.py``): a loop that scans
``--output_dir`` for the newest ``checkpoint-step_N``, puts it on the
pipeline's DiT, renders a fixed set of validation prompts and saves the
videos next to the checkpoint. It runs on ``--device`` (default
``cuda``).

An adapter-only checkpoint (``cli.finetune --use_lora``; ``meta.json``
says ``lora``) is restored into a template built from the base and
attached to it as the rank-r side path, so a quantized or full-precision
base renders base + adapters. A full checkpoint is restored into the
pristine base: any adapters of an earlier scan come off first (the JAX
watcher restores it into the tree that still carries them), and a copy
of the base is kept in host memory so that a later adapter-only
checkpoint is attached to the base, not to the fine-tuned weights.

Example:
    python -m moviigen_tpu_torch.cli.valid_training --task t2v-14B \\
        --output_dir outputs --size 832*480 --frame_num 17 --once
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import time

from ..configs import SIZE_CONFIGS, WAN_CONFIGS

NEGATIVE_PROMPTS = {
    # ref valid_training.py:270-275 selectable CH/EN negative prompt
    "ch": None,  # falls back to the config default (Chinese)
    "en": (
        "Vibrant colors, overexposed, static, blurry details, subtitles, "
        "stylized, artwork, painting, still image, overall grayish, worst "
        "quality, low quality, JPEG compression artifacts, ugly, "
        "incomplete, extra fingers, poorly drawn hands, poorly drawn "
        "face, deformed, disfigured, deformed limbs, merged fingers, "
        "motionless frame, cluttered background, three legs, crowded "
        "background, walking backwards"
    ),
}


def _load_prompts(prompt_dir: str):
    prompts = []
    for f in sorted(glob.glob(os.path.join(prompt_dir, "*.txt"))):
        with open(f) as fh:
            text = fh.read().strip()
        if text:
            prompts.append((os.path.splitext(os.path.basename(f))[0], text))
    return prompts


def _parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Watch a training dir and render validation prompts "
                    "(PyTorch/CUDA)")
    p.add_argument("--task", type=str, default="t2v-14B",
                   choices=[t for t in WAN_CONFIGS if "i2v" not in t])
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to render on (default: cuda)")
    p.add_argument("--output_dir", type=str, required=True,
                   help="training output dir to watch for checkpoints")
    p.add_argument("--ckpt_dir", type=str, default=None,
                   help="base checkpoint dir (DiT, T5, VAE, tokenizer); "
                        "random weights if unset")
    p.add_argument("--prompt_dir", type=str,
                   default="assets/valid_data_t2v")
    p.add_argument("--size", type=str, default="1280*720",
                   choices=list(SIZE_CONFIGS))
    p.add_argument("--frame_num", type=int, default=81)
    p.add_argument("--sample_steps", type=int, default=50)
    p.add_argument("--sample_shift", type=float, default=5.0)
    p.add_argument("--sample_guide_scale", type=float, default=5.0)
    p.add_argument("--base_seed", type=int, default=42)
    p.add_argument("--neg_prompt_lang", type=str, default="ch",
                   choices=["ch", "en"])
    p.add_argument("--poll_interval", type=int, default=10)
    p.add_argument("--once", action="store_true",
                   help="run a single scan/render cycle")
    return p.parse_args(argv)


class _Watcher:
    """The pipeline and what the scans have put on its DiT."""

    def __init__(self, cfg, args):
        from ..pipelines.text2video import WanT2V

        self.pipe = WanT2V(config=cfg, checkpoint_dir=args.ckpt_dir,
                           device=args.device)
        self._base = None  # host copy of the base, once a full ckpt lands

    def load(self, path: str) -> dict:
        """Put checkpoint ``path`` on the DiT; returns its meta."""
        import torch

        from ..training.checkpoint import read_meta, restore_checkpoint
        from ..training.lora import init_lora_params, lora_state_dict

        dit = self.pipe.dit
        meta = read_meta(path)
        self.pipe.detach_lora()
        if meta.get("lora"):
            if self._base is not None:  # back to the pristine base
                with torch.no_grad():
                    for name, p in dit.named_parameters():
                        p.copy_(self._base[name])
            rank = int(meta.get("lora_rank", 64))
            alpha = float(meta.get("lora_alpha", 64))
            template = init_lora_params(
                dit, rank=rank,
                dtype=getattr(torch, meta.get("lora_dtype", "float32")))
            restore_checkpoint(path, lora_state_dict(template))
            self.pipe.attach_lora(template, alpha=alpha, rank=rank)
            logging.info("attached rank-%d adapters (alpha=%g)", rank, alpha)
        else:
            if self._base is None:
                self._base = {n: p.detach().to("cpu", copy=True)
                              for n, p in dit.named_parameters()}
            restore_checkpoint(path, dit)
            logging.info("restored the fine-tuned DiT into the base")
        return meta


def main(argv=None) -> dict:
    """Watch and render; returns the record of the renders (one entry per
    checkpoint: ``step``, ``checkpoint``, ``lora``, ``videos`` as
    {name: [C, F, H, W] array}, ``saved`` paths) and the ``pipe``."""
    args = _parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s] %(levelname)s: %(message)s")

    from ..training.checkpoint import latest_checkpoint
    from ..utils.io import cache_video

    cfg = WAN_CONFIGS[args.task]
    record = {"renders": [], "pipe": None}
    prompts = _load_prompts(args.prompt_dir)
    if not prompts:
        logging.warning("no validation prompts in %s", args.prompt_dir)
        return record
    n_prompt = NEGATIVE_PROMPTS[args.neg_prompt_lang] or ""

    last_step = -1
    watcher = None
    while True:
        found = latest_checkpoint(args.output_dir)
        if found and found[1] > last_step:
            path, step = found
            logging.info("new checkpoint: %s (step %d)", path, step)
            if watcher is None:
                watcher = _Watcher(cfg, args)
                record["pipe"] = watcher.pipe
            meta = watcher.load(path)
            last_step = step

            save_dir = os.path.join(path, "validation_videos")
            os.makedirs(save_dir, exist_ok=True)
            render = {"step": step, "checkpoint": path,
                      "lora": bool(meta.get("lora")), "videos": {},
                      "saved": []}
            for name, prompt in prompts:
                logging.info("rendering %s: %s", name, prompt[:60])
                video = watcher.pipe.generate(
                    prompt, size=SIZE_CONFIGS[args.size],
                    frame_num=args.frame_num, shift=args.sample_shift,
                    sampling_steps=args.sample_steps,
                    guide_scale=args.sample_guide_scale, n_prompt=n_prompt,
                    seed=args.base_seed)
                out = cache_video(
                    video, os.path.join(save_dir, f"{name}_step{step}.mp4"),
                    fps=cfg.sample_fps)
                logging.info("saved %s", out)
                render["videos"][name] = video
                render["saved"].append(out)
            record["renders"].append(render)
        if args.once:
            break
        time.sleep(args.poll_interval)
    return record


if __name__ == "__main__":
    main()
