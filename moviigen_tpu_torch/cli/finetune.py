"""Fine-tuning CLI of the PyTorch port: full or LoRA / QLoRA fine-tuning
of the t2v DiT on one device.

Counterpart of ``moviigen_tpu/cli/finetune.py`` (ref
``scripts/train/finetune.py``): the same flag surface and loop — the
precomputed-latent dataset, the bucket sampler, the flow-matching step
with clip, AdamW, LR schedule and grad accumulation, TensorBoard metrics
when ``tensorboard`` is installed (per-timestep-bin losses included),
periodic, final and SIGINT/SIGTERM checkpoints, resume, OT noise
pairing (``--compute_ot``). ``--use_lora`` trains rank-r adapters on the
attention projections of a frozen base (``training/lora.py``), which
``--quant int8|int4`` stores weight-only quantized (QLoRA: how the 14B
trains on one card); checkpoints then hold the adapters alone, and
``--export_safetensors`` writes them in peft layout. It runs on
``--device`` (default ``cuda``; ``--device cpu`` for t2v-tiny on the
CPU). Flags of later slices of the port are accepted by the parser and
refused with an error naming the ROADMAP item that brings them.

Examples:
    python -m moviigen_tpu_torch.cli.finetune --task t2v-1.3B \\
        --data_json_path data/preprocess/videos2caption.json \\
        --gradient_checkpointing --max_train_steps 6000
    python -m moviigen_tpu_torch.cli.finetune --task t2v-14B --use_lora \\
        --quant int8 --gradient_checkpointing --export_safetensors \\
        --data_json_path data/preprocess/videos2caption.json
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import time
from collections import deque

import numpy as np
import torch

from ..configs import ATTN_BACKENDS, WAN_CONFIGS

# flag → (value that means "not used", ROADMAP item that brings it)
LATER_SLICE_FLAGS = {
    "ffn_bwd_chunk": (None, "the memory knobs (ROADMAP queue 1 item 13)"),
    "attn_bwd_chunk": (None, "the memory knobs (ROADMAP queue 1 item 13)"),
    "profile_steps": (0, "utils/profiling.py as torch.profiler (ROADMAP "
                         "queue 1 item 13)"),
}


def _parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Fine-tune the T2V DiT (PyTorch/CUDA)")
    # model / data (ref finetune.py:692-924)
    p.add_argument("--task", type=str, default="t2v-14B",
                   choices=list(WAN_CONFIGS))
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (default: cuda)")
    p.add_argument("--ckpt_dir", type=str, default=None,
                   help="reference-layout DiT checkpoint dir (diffusers "
                        "safetensors shards); random init if unset")
    p.add_argument("--resume_from_checkpoint", type=str, default=None)
    p.add_argument("--data_json_path", type=str, required=True)
    p.add_argument("--num_latent_t", type=int, default=21)
    p.add_argument("--max_seq_len", type=int, default=32760)
    p.add_argument("--cfg", type=float, default=0.0, dest="cfg_rate")
    p.add_argument("--output_dir", type=str, default="./outputs")
    # loop
    p.add_argument("--train_batch_size", type=int, default=1)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--max_train_steps", type=int, default=100)
    p.add_argument("--checkpointing_steps", type=int, default=500)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--gradient_checkpointing", action="store_true")
    p.add_argument("--residual_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="residual-stream dtype of the block stack")
    p.add_argument("--remat_group", type=int, default=1,
                   help="checkpoint every g-th residual of the block stack "
                        "(nested remat; needs --gradient_checkpointing)")
    p.add_argument("--ffn_bwd_chunk", type=int, default=None)
    p.add_argument("--attn_bwd_chunk", type=int, default=None)
    # optim
    p.add_argument("--learning_rate", type=float, default=1e-6)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--lr_scheduler", type=str, default="constant",
                   choices=["constant", "linear", "cosine"])
    p.add_argument("--lr_warmup_steps", type=int, default=0)
    # flow matching
    p.add_argument("--compute_ot", action="store_true")
    p.add_argument("--weighting_scheme", type=str, default="uniform",
                   choices=["uniform", "logit_normal", "mode"])
    p.add_argument("--logit_mean", type=float, default=0.0)
    p.add_argument("--logit_std", type=float, default=1.0)
    p.add_argument("--mode_scale", type=float, default=1.29)
    # parallel
    p.add_argument("--sp_size", type=int, default=1)
    # lora
    p.add_argument("--use_lora", action="store_true")
    p.add_argument("--lora_rank", type=int, default=64)
    p.add_argument("--lora_alpha", type=int, default=64)
    p.add_argument("--quant", type=str, default=None,
                   choices=["int8", "int4"])
    p.add_argument("--lora_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--cross_attn_backend", type=str, default=None,
                   choices=list(ATTN_BACKENDS),
                   help="attention backend override for the cross-"
                        "attention sites only")
    # misc
    p.add_argument("--export_safetensors", action="store_true",
                   help="also write reference-layout safetensors")
    p.add_argument("--profile_steps", type=int, default=0)
    return p.parse_args(argv)


def _validate_args(args) -> None:
    if "i2v" in args.task:
        # the JAX trainer passes no y and no clip_fea (cli/finetune.py:
        # 272-281) and its loader reads neither, so it cannot train i2v
        # either; the port adds no feature the JAX package lacks
        raise NotImplementedError(
            f"task {args.task!r}: i2v fine-tuning is not supported (the JAX "
            "package has no i2v trainer to port)")
    for flag, (unused, item) in LATER_SLICE_FLAGS.items():
        if getattr(args, flag) != unused:
            raise NotImplementedError(
                f"--{flag} is not supported by the PyTorch port yet; it "
                f"comes with {item}")
    if args.quant and not args.use_lora:
        raise SystemExit("--quant requires --use_lora (the packed base is "
                         "frozen; only adapters train)")
    if args.sp_size != 1:
        raise NotImplementedError(
            "--sp_size > 1 is not supported by the PyTorch port yet; it "
            "comes with the multi-GPU slice (ROADMAP queue 1 item 11)")
    if args.remat_group > 1 and not args.gradient_checkpointing:
        raise ValueError("--remat_group needs --gradient_checkpointing")


def main(argv=None) -> dict:
    """Run the fine-tune; returns the run's record: the last step, the
    per-step seconds, losses and grad norms, the final checkpoint's path
    and the seconds its save took, and the trained model, optimizer and
    LoRA adapters (None for a full fine-tune)."""
    args = _parse_args(argv)
    _validate_args(args)
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s] %(levelname)s: %(message)s")

    from ..models.wan_convert import load_wan_checkpoint
    from ..models.wan_model import WanModel
    from ..ops.rope import rope_3d_freqs
    from ..pipelines.text2video import resolve_device
    from ..training import TrainConfig, make_optimizer, make_train_step
    from ..training.checkpoint import (LORA_EXPORT_NAME,
                                       export_lora_safetensors,
                                       latest_checkpoint, restore_checkpoint,
                                       save_checkpoint)
    from ..training.data import (
        DataLoader, LatentDataset,
        SPAwareAspectRatioLengthBucketDistributedSampler)
    from ..training.lora import (attach_lora, init_lora_params,
                                 lora_parameters, lora_state_dict)

    device = resolve_device(args.device)
    cfg = WAN_CONFIGS[args.task]
    mcfg = cfg.model
    if args.cross_attn_backend:
        mcfg = mcfg.replace(cross_attn_backend=args.cross_attn_backend)

    # ---- model: fp32 master weights, bf16 compute (as the JAX CLI); for
    # QLoRA the block linears are quantized weight-only as they load, or
    # made as random codes on the device: the full-precision 14B (56 GB)
    # never exists there
    if args.ckpt_dir:
        model = load_wan_checkpoint(args.ckpt_dir, mcfg, dtype=torch.float32,
                                    device=device, quant=args.quant)
    else:
        logging.warning("random-init DiT (no --ckpt_dir)")
        model = WanModel(mcfg, dtype=torch.float32, device=device,
                         quant=args.quant)
        model.init_weights(torch.Generator(device=device)
                           .manual_seed(args.seed))
    if args.quant:
        logging.info("frozen base quantized to %s", args.quant)
    model.train()
    adapters = None
    if args.use_lora:
        # the base is frozen; the adapters (drawn from seed + 1, as the JAX
        # CLI's PRNGKey(seed + 1)) are the only trainable tensors
        model.requires_grad_(False)
        adapters = init_lora_params(
            model, rank=args.lora_rank, dtype=getattr(torch, args.lora_dtype),
            generator=torch.Generator(device=device)
            .manual_seed(args.seed + 1))
        attach_lora(model, adapters, alpha=args.lora_alpha,
                    rank=args.lora_rank)
        trainable = list(lora_parameters(adapters))
        logging.info("LoRA rank %d alpha %g on %d linears, %d parameters",
                     args.lora_rank, args.lora_alpha, len(adapters),
                     sum(p.numel() for p in trainable))
    else:
        trainable = list(model.parameters())

    # ---- data
    dataset = LatentDataset(args.data_json_path, args.num_latent_t,
                            cfg_rate=args.cfg_rate,
                            txt_max_len=mcfg.text_len,
                            text_dim=mcfg.text_dim, seed=args.seed)
    sampler = SPAwareAspectRatioLengthBucketDistributedSampler(
        batch_size=args.train_batch_size, dataset_size=len(dataset), rank=0,
        world_size=1, sp_size=1, lengths=dataset.lengths,
        aspect_ratios=list(dataset.aspect_ratios), seed=args.seed)
    loader = DataLoader(dataset, sampler, batch_size=args.train_batch_size)

    # ---- rope / step fn (shapes from the first item)
    c, t_lat, h_lat, w_lat = dataset[0][0].shape
    grid = (t_lat // mcfg.patch_size[0], h_lat // mcfg.patch_size[1],
            w_lat // mcfg.patch_size[2])
    rope = rope_3d_freqs(grid, mcfg.head_dim, device=device)
    tokens = int(np.prod(grid))
    logging.info("latent %s → grid %s (%d tokens)", (c, t_lat, h_lat, w_lat),
                 grid, tokens)

    tc = TrainConfig(
        learning_rate=args.learning_rate,
        weight_decay=args.weight_decay,
        max_grad_norm=args.max_grad_norm,
        weighting_scheme=args.weighting_scheme,
        logit_mean=args.logit_mean, logit_std=args.logit_std,
        mode_scale=args.mode_scale,
        num_train_timesteps=cfg.num_train_timesteps,
        remat=args.gradient_checkpointing,
        residual_dtype=args.residual_dtype,
        remat_group=args.remat_group,
        grad_accum_steps=args.gradient_accumulation_steps,
        compute_ot=args.compute_ot,
        lr_scheduler=args.lr_scheduler,
        lr_warmup_steps=args.lr_warmup_steps,
        max_train_steps=args.max_train_steps,
    )
    opt = make_optimizer(trainable, tc)
    train_step = make_train_step(
        model, tc, rope, opt,
        generator=torch.Generator(device=device).manual_seed(args.seed))

    # ---- resume
    start_step = 0
    if args.resume_from_checkpoint:
        path = args.resume_from_checkpoint
        if path == "latest":
            found = latest_checkpoint(args.output_dir)
            path = found[0] if found else None
        if path:
            start_step = restore_checkpoint(
                path, lora_state_dict(adapters) if adapters else model, opt)
            logging.info("resumed from %s at step %d", path, start_step)

    # ---- TensorBoard (ref finetune.py:326-327, 641-656), when installed
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        writer = None
    else:
        writer = SummaryWriter(os.path.join(args.output_dir, "logs"))

    def do_save(step, is_final=False):
        meta = {"final": is_final, "lora": bool(args.use_lora),
                "quant": args.quant or "none"}
        if adapters:
            # what the watcher needs to rebuild the A/B template and apply
            # the alpha/rank scale when it attaches them to a base
            meta.update(lora_rank=args.lora_rank, lora_alpha=args.lora_alpha,
                        lora_dtype=args.lora_dtype)
        path = save_checkpoint(
            args.output_dir, step,
            lora_state_dict(adapters) if adapters else model, opt,
            extra_meta=meta,
            export_safetensors=args.export_safetensors and not adapters)
        if adapters and args.export_safetensors:
            # the adapters in peft layout (ref save_lora_checkpoint,
            # finetune.py:501-502), never the full model
            export_lora_safetensors(os.path.join(path, LORA_EXPORT_NAME),
                                    adapters, alpha=args.lora_alpha,
                                    rank=args.lora_rank)
        logging.info("saved checkpoint %s", path)
        return path

    # signal-triggered checkpoint (ref finetune.py:159-169, 508-510)
    def handler(signum, frame):
        logging.info("signal %d: checkpointing before exit", signum)
        do_save(step, is_final=True)
        sys.exit(0)

    prev_int = signal.signal(signal.SIGINT, handler)
    prev_term = signal.signal(signal.SIGTERM, handler)

    record = {"step_s": [], "loss": [], "grad_norm": []}
    step_times = deque(maxlen=100)
    step = start_step
    epoch = 0
    try:
        while step < args.max_train_steps:
            sampler.set_epoch(epoch)
            dataset.set_epoch(epoch)
            for latents, embeds, _, embed_mask in loader:
                if step >= args.max_train_steps:
                    break
                t0 = time.perf_counter()
                # zero the padded text positions (the reference's semantics)
                embeds = embeds * embed_mask[..., None]
                batch = {"latents": torch.from_numpy(latents).to(device),
                         "context": torch.from_numpy(embeds).to(device)}
                metrics = train_step(batch)
                loss = float(metrics["loss"])  # scalar readback = sync point
                gnorm = float(metrics["grad_norm"])
                step += 1
                dt = time.perf_counter() - t0
                step_times.append(dt)
                record["step_s"].append(dt)
                record["loss"].append(loss)
                record["grad_norm"].append(gnorm)
                if writer is not None:
                    writer.add_scalar("loss", loss, step)
                    writer.add_scalar("grad_norm", gnorm, step)
                    writer.add_scalar("epoch", epoch, step)
                    writer.add_scalar("time/step_time", dt, step)
                    writer.add_scalar("time/avg_step_time",
                                      sum(step_times) / len(step_times), step)
                    # per-timestep-bin loss (ref finetune.py:641-656)
                    bin_i = int(float(metrics["timestep_mean"]) // 100)
                    writer.add_scalar(f"loss_bin_{bin_i}", loss, step)
                if step % 10 == 0 or step == 1:
                    logging.info("step %d loss %.5f grad_norm %.4f %.2fs/step",
                                 step, loss, gnorm, dt)
                if step % args.checkpointing_steps == 0:
                    do_save(step)
            epoch += 1
        t0 = time.perf_counter()
        record["checkpoint"] = do_save(step, is_final=True)
        record["checkpoint_s"] = time.perf_counter() - t0
    finally:
        signal.signal(signal.SIGINT, prev_int)
        signal.signal(signal.SIGTERM, prev_term)
        if writer is not None:
            writer.close()
    record.update(step=step, model=model, optimizer=opt, adapters=adapters)
    logging.info("training done at step %d", step)
    return record


if __name__ == "__main__":
    main()
