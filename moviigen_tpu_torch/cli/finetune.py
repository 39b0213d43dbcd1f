"""Fine-tuning CLI of the PyTorch port: full or LoRA / QLoRA fine-tuning
of the t2v DiT on one card or, under ``torchrun``, on a mesh of ranks.

Counterpart of ``moviigen_tpu/cli/finetune.py`` (ref
``scripts/train/finetune.py``): the same flag surface and loop — the
precomputed-latent dataset, the bucket sampler, the flow-matching step
with clip, AdamW, LR schedule and grad accumulation, TensorBoard metrics
when ``tensorboard`` is installed (per-timestep-bin losses included),
periodic, final and SIGINT/SIGTERM checkpoints, resume (with the
generator's state and the loader's place, so that the resumed steps are
the ones the run would have taken), OT noise pairing
(``--compute_ot``). ``--use_lora`` trains rank-r adapters on the
attention projections of a frozen base (``training/lora.py``), which
``--quant int8|int4`` stores weight-only quantized (QLoRA: how the 14B
trains on one card); checkpoints then hold the adapters alone, and
``--export_safetensors`` writes them in peft layout. It runs on
``--device`` (default ``cuda``; ``--device cpu`` for t2v-tiny on the
CPU). The loader reads each batch's ``.npy`` caches through the native
reader pool (``native/``) when it can be built. ``--profile_steps N``
traces the first N steps with torch.profiler into
``<output_dir>/profile`` (a Chrome trace) and logs their phase times.
The JAX memory knobs (not ported, by design) are accepted by the parser
and refused.

Under ``torchrun`` the ranks form a ``(data, seq)`` mesh (the JAX CLI's,
finetune.py:149-153): ``--sp_size`` ranks of Ulysses sequence parallelism
each, the world size over ``--sp_size`` data-parallel groups, the nodes
spanning ``data`` (``make_pod_mesh``). The DiT's block weights, their
gradients and AdamW moments are held as shards over ``seq`` and gathered
per block (``parallel/sharding.py``); with ``--use_lora`` the frozen
(quantized) base is sharded and the adapters replicated. Every rank reads
the same global batch of ``--train_batch_size`` × data items (the
sampler's rank-0 view) and draws the same noise; rank 0 logs, writes
TensorBoard and the checkpoints (gathered one tensor at a time into the
one-process layout), the others take part in the collectives. Over NCCL
each rank needs a card of its own; ``--device cpu`` runs the ranks over
gloo.

Examples:
    python -m moviigen_tpu_torch.cli.finetune --task t2v-1.3B \\
        --data_json_path data/preprocess/videos2caption.json \\
        --gradient_checkpointing --max_train_steps 6000
    python -m moviigen_tpu_torch.cli.finetune --task t2v-14B --use_lora \\
        --quant int8 --gradient_checkpointing --export_safetensors \\
        --data_json_path data/preprocess/videos2caption.json
    torchrun --nproc_per_node 8 -m moviigen_tpu_torch.cli.finetune \\
        --task t2v-14B --sp_size 8 --gradient_checkpointing \\
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

# the memory knobs of the JAX trainer, for 16 GB TPU chips: accepted by the
# parser and refused, not ported by design (an 80 GB card has no use for
# them; ROADMAP, "Not ported, by design")
MEMORY_KNOBS = ("ffn_bwd_chunk", "attn_bwd_chunk")


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
    for flag in MEMORY_KNOBS:
        if getattr(args, flag) is not None:
            raise NotImplementedError(
                f"--{flag} is not supported by the PyTorch port: the memory "
                "knobs are not ported, by design (an 80 GB card has no use "
                "for them; ROADMAP, 'Not ported, by design')")
    if args.quant and not args.use_lora:
        raise SystemExit("--quant requires --use_lora (the packed base is "
                         "frozen; only adapters train)")
    if args.sp_size < 1:
        raise ValueError(f"--sp_size must be >= 1, got {args.sp_size}")
    if args.remat_group > 1 and not args.gradient_checkpointing:
        raise ValueError("--remat_group needs --gradient_checkpointing")


def build_mesh(args):
    """The ``(data, seq)`` mesh over the process group's ranks (the JAX
    CLI's, finetune.py:143-153), or None in a process alone."""
    from ..parallel import distributed
    from ..parallel.mesh import make_pod_mesh

    sp = args.sp_size
    if not distributed.is_initialized():
        if sp > 1:
            raise ValueError(f"--sp_size {sp} needs {sp} ranks: launch "
                             "them with torchrun (moviigen_tpu_torch/"
                             "scripts/finetune.sh)")
        return None
    import torch.distributed as dist

    world = dist.get_world_size()
    if world % sp:
        raise ValueError(f"--sp_size {sp} must divide the world size "
                         f"{world}")
    mesh = make_pod_mesh(data=world // sp, seq=sp)
    logging.info("mesh: data %d x seq %d", world // sp, sp)
    return mesh


def _loader_position(sampler, batch_size: int, steps: int):
    """(epoch, batch in it) of the loader after ``steps`` batches from
    the start: each epoch's batches counted from the sampler's indices,
    no data read."""
    epoch = 0
    while True:
        sampler.set_epoch(epoch)
        n = sum(1 for _ in sampler) // batch_size
        if n == 0 or steps < n:
            return epoch, steps
        steps -= n
        epoch += 1


def main(argv=None) -> dict:
    """Run the fine-tune; returns the run's record: the last step, the
    per-step seconds, losses and grad norms, the final checkpoint's path
    and the seconds its save took, the trained model (under a mesh this
    rank's sharded copy), optimizer and LoRA adapters (None for a full
    fine-tune), the mesh's comm (None in a process alone), the profiler's
    ``Trace`` (None without ``--profile_steps``) and the batches the
    loader read through the native pool and in Python. Under ``torchrun``
    the process group is brought up first and, if this call brought it
    up, taken down at the end."""
    from ..parallel import distributed

    args = _parse_args(argv)
    _validate_args(args)
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s] %(levelname)s: %(message)s")
    owned = not distributed.is_initialized()
    distributed.maybe_initialize_distributed(device=args.device)
    try:
        return _main(args)
    finally:
        if owned and distributed.is_initialized():
            import torch.distributed as dist

            dist.destroy_process_group()


def _main(args) -> dict:
    from ..models.wan_convert import load_wan_checkpoint
    from ..models.wan_model import WanModel
    from ..ops.rope import rope_3d_freqs
    from ..parallel import distributed
    from ..parallel.comm import AXES
    from ..parallel.sharding import dit_param_specs, shard_axis, shard_params
    from ..pipelines.text2video import resolve_device
    from ..training import TrainConfig, make_optimizer, make_train_step
    from ..training.checkpoint import (
        LORA_EXPORT_NAME, export_lora_safetensors, latest_checkpoint,
        restore_checkpoint, save_checkpoint)
    from ..training.data import (
        DataLoader, LatentDataset,
        SPAwareAspectRatioLengthBucketDistributedSampler)
    from ..training.lora import (attach_lora, init_lora_params,
                                 lora_parameters, lora_state_dict)
    from ..utils.profiling import PhaseTimer, trace

    mesh = build_mesh(args)
    writer = mesh is None or mesh.rank == 0
    if not writer:  # rank 0 logs; the others say only what goes wrong
        logging.getLogger().setLevel(logging.WARNING)
    device = resolve_device(distributed.local_device(args.device))
    data_par = 1 if mesh is None else mesh.axis_size("data")
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
    if mesh is not None:
        # the block weights (a QLoRA base's codes and scales) as shards
        # over seq; the adapters, which the shards' modules carry, stay
        # the same tensors, replicated
        model = shard_params(model, dit_param_specs(model), mesh,
                             shard_axis(mesh))
        logging.info("DiT block weights sharded over %d ranks",
                     mesh.axis_size(shard_axis(mesh)))
    if not args.use_lora:
        trainable = list(model.parameters())

    # ---- data
    dataset = LatentDataset(args.data_json_path, args.num_latent_t,
                            cfg_rate=args.cfg_rate,
                            txt_max_len=mcfg.text_len,
                            text_dim=mcfg.text_dim, seed=args.seed)
    # every rank reads the global batch (the sampler's rank-0 view), as
    # the JAX CLI's one process does (finetune.py:174-180); the SP forward
    # takes each rank's rows
    batch_size = args.train_batch_size * data_par
    sampler = SPAwareAspectRatioLengthBucketDistributedSampler(
        batch_size=batch_size, dataset_size=len(dataset), rank=0,
        world_size=1, sp_size=1, lengths=dataset.lengths,
        aspect_ratios=list(dataset.aspect_ratios), seed=args.seed)
    loader = DataLoader(dataset, sampler, batch_size=batch_size)
    logging.info("native reader pool %s", "in use" if loader.uses_native
                 else "unavailable: batches read in Python")

    # ---- rope / step fn (shapes from the first item)
    c, t_lat, h_lat, w_lat = dataset[0][0].shape
    grid = (t_lat // mcfg.patch_size[0], h_lat // mcfg.patch_size[1],
            w_lat // mcfg.patch_size[2])
    rope = rope_3d_freqs(grid, mcfg.head_dim, device=device)
    tokens = int(np.prod(grid))
    sp = args.sp_size
    seq_len = -(-tokens // sp) * sp  # the tokens padded to split over sp
    logging.info("latent %s → grid %s (%d tokens, seq_len %d)",
                 (c, t_lat, h_lat, w_lat), grid, tokens, seq_len)

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
    opt = make_optimizer(trainable, tc, comm=mesh)
    # the noise and timestep draws; checkpointed with the optimizer
    gen = torch.Generator(device=device).manual_seed(args.seed)
    train_step = make_train_step(
        model, tc, rope, opt,
        seq_len=seq_len if seq_len > tokens else None,
        generator=gen, comm=mesh)

    # ---- resume: the weights, the optimizer and the generator as the
    # run left them, and the loader at the batch after its last step, so
    # that the resumed steps are the ones the run would have taken
    start_step = 0
    epoch = 0
    if args.resume_from_checkpoint:
        path = args.resume_from_checkpoint
        if path == "latest":
            found = latest_checkpoint(args.output_dir)
            path = found[0] if found else None
        if path:
            target = lora_state_dict(adapters) if adapters else model
            start_step = restore_checkpoint(path, target, opt, comm=mesh,
                                            generator=gen)
            epoch, skip = _loader_position(sampler, batch_size, start_step)
            loader.skip_batches(skip)
            logging.info("resumed from %s at step %d (epoch %d, batch %d)",
                         path, start_step, epoch, skip)

    # ---- TensorBoard (ref finetune.py:326-327, 641-656), when installed,
    # on rank 0
    tb = None
    if writer:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            pass
        else:
            tb = SummaryWriter(os.path.join(args.output_dir, "logs"))

    def do_save(step, is_final=False):
        meta = {"final": is_final, "lora": bool(args.use_lora),
                "quant": args.quant or "none"}
        if adapters:
            # what the watcher needs to rebuild the A/B template and apply
            # the alpha/rank scale when it attaches them to a base
            meta.update(lora_rank=args.lora_rank, lora_alpha=args.lora_alpha,
                        lora_dtype=args.lora_dtype)
        target = lora_state_dict(adapters) if adapters else model
        path = save_checkpoint(
            args.output_dir, step, target, opt, extra_meta=meta,
            export_safetensors=args.export_safetensors and not adapters,
            comm=mesh, generator=gen)
        if not writer:
            return path
        if adapters and args.export_safetensors:
            # the adapters in peft layout (ref save_lora_checkpoint,
            # finetune.py:501-502), never the full model
            export_lora_safetensors(os.path.join(path, LORA_EXPORT_NAME),
                                    adapters, alpha=args.lora_alpha,
                                    rank=args.lora_rank)
        logging.info("saved checkpoint %s", path)
        return path

    # signal-triggered checkpoint (ref finetune.py:159-169, 508-510): the
    # handler only takes note, and the loop saves after the step, where
    # the parameters are whole and, under a mesh, where every rank stands:
    # the save's gathers are collectives, and a rank inside the step's
    # would pair them with the wrong ones
    signalled = []

    def handler(signum, frame):
        logging.info("signal %d: checkpointing after this step", signum)
        signalled.append(signum)

    def stop_now() -> bool:
        """Whether any rank took a signal (the same answer on every
        rank)."""
        if mesh is None:
            return bool(signalled)
        flag = torch.tensor(float(bool(signalled)), device=device)
        return bool(mesh.all_reduce(flag, AXES) > 0)

    prev_int = signal.signal(signal.SIGINT, handler)
    prev_term = signal.signal(signal.SIGTERM, handler)

    record = {"step_s": [], "loss": [], "grad_norm": [], "profile": None}
    step_times = deque(maxlen=100)
    step = start_step
    # the first --profile_steps steps under torch.profiler (the JAX CLI's
    # window: opened before the first step, closed after step N - 1), on
    # rank 0
    timer = PhaseTimer(enabled=args.profile_steps > 0)
    profile_ctx = None
    if args.profile_steps > 0 and writer:
        profile_ctx = trace(os.path.join(args.output_dir, "profile"),
                            device=device)
        record["profile"] = profile_ctx.__enter__()

    def close_profile():
        nonlocal profile_ctx
        if profile_ctx is not None:
            profile_ctx.__exit__(None, None, None)
            profile_ctx = None
            logging.info("profiler trace written to %s; phases: %s",
                         record["profile"].path, timer.report())

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
                with timer.phase("step"):
                    metrics = train_step(batch)
                    # scalar readback = sync point
                    loss = float(metrics["loss"])
                if step + 1 >= args.profile_steps:
                    close_profile()
                gnorm = float(metrics["grad_norm"])
                step += 1
                dt = time.perf_counter() - t0
                step_times.append(dt)
                record["step_s"].append(dt)
                record["loss"].append(loss)
                record["grad_norm"].append(gnorm)
                if tb is not None:
                    tb.add_scalar("loss", loss, step)
                    tb.add_scalar("grad_norm", gnorm, step)
                    tb.add_scalar("epoch", epoch, step)
                    tb.add_scalar("time/step_time", dt, step)
                    tb.add_scalar("time/avg_step_time",
                                  sum(step_times) / len(step_times), step)
                    # per-timestep-bin loss (ref finetune.py:641-656)
                    bin_i = int(float(metrics["timestep_mean"]) // 100)
                    tb.add_scalar(f"loss_bin_{bin_i}", loss, step)
                if step % 10 == 0 or step == 1:
                    logging.info("step %d loss %.5f grad_norm %.4f %.2fs/step",
                                 step, loss, gnorm, dt)
                if stop_now():
                    do_save(step, is_final=True)
                    sys.exit(0)
                if step % args.checkpointing_steps == 0:
                    do_save(step)
            epoch += 1
        t0 = time.perf_counter()
        record["checkpoint"] = do_save(step, is_final=True)
        record["checkpoint_s"] = time.perf_counter() - t0
    finally:
        close_profile()
        loader.close()
        signal.signal(signal.SIGINT, prev_int)
        signal.signal(signal.SIGTERM, prev_term)
        if tb is not None:
            tb.close()
    record.update(step=step, model=model, optimizer=opt, adapters=adapters,
                  comm=mesh,
                  native_batches=loader.native_batches,
                  python_batches=loader.python_batches)
    logging.info("training done at step %d", step)
    return record


if __name__ == "__main__":
    main()
