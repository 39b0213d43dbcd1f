"""Text→video and image→video generation CLI of the PyTorch port.

Counterpart of ``moviigen_tpu/cli/generate.py`` for the t2v, t2i and i2v
tasks, on one device (``--device``, default ``cuda``) or, under
``torchrun``, on one card per rank.

Examples:
    python -m moviigen_tpu_torch.cli.generate --task t2v-14B \\
        --size 832*480 --frame_num 17 --sample_steps 4 --quant w8a8
    python -m moviigen_tpu_torch.cli.generate --task i2v-14B \\
        --size 832*480 --image first_frame.png
    torchrun --nproc_per_node 4 -m moviigen_tpu_torch.cli.generate \\
        --task t2v-14B --size 1280*720 --ulysses_size 4 --dit_fsdp --t5_fsdp

Sequence parallelism follows the JAX CLI's rules (``generate.py:144-183``):
with ``--ulysses_size U``, ``--ring_size R``, ``--dit_fsdp`` or
``--t5_fsdp`` the ranks form a mesh, sp = U·R must divide the world size,
the ``data`` axis (the CFG pair) is ``min(world // sp, 2)``, and the mode
is usp (U > 1 and R > 1), ring (R > 1) or ulysses. Under a mesh both the
umT5 and the DiT hold their block weights as shards gathered per block,
as the JAX pipeline shards both whenever it has a mesh. Rank 0 writes the
video; ``--device cpu`` runs the ranks over gloo.

``--image`` (i2v, required there) is read as the JAX CLI reads it: RGB,
resized to the request's size, scaled to [-1, 1].

``--use_prompt_extend`` rewrites the prompt with an LLM before it is
tokenized (``utils/prompt_extend.py``: ``--prompt_extend_method
local_qwen`` on the request's device, or ``dashscope``); where the
rewriter fails (no weights, no SDK) it warns and keeps the prompt.

``--ckpt_dir`` names a checkpoint directory in the reference layout (DiT
safetensors shards, ``models_t5_umt5-xxl-enc-bf16.pth``,
``Wan2.1_VAE.pth``, the tokenizer folder); without it the weights are
random. ``--quant int8|int4|w8a8`` quantizes the DiT's block linears (and
a large umT5); with ``--ckpt_dir`` the quantized trees are cached beside
the checkpoint.
"""

from __future__ import annotations

import argparse
import logging
from datetime import datetime
from typing import Optional

import numpy as np

from ..configs import SIZE_CONFIGS, SUPPORTED_SIZES, WAN_CONFIGS
from ..utils.io import cache_image, cache_video, str2bool

EXAMPLE_PROMPT = {
    "t2v-14B": "Two anthropomorphic cats in comfy boxing gear and bright "
               "gloves fight intensely on a spotlighted stage.",
    "t2v-1.3B": "Two anthropomorphic cats in comfy boxing gear and bright "
                "gloves fight intensely on a spotlighted stage.",
    "t2i-14B": "一个朴素端庄的美人",
    "t2v-tiny": "a tiny test video",
    "i2v-14B": "Summer beach vacation style, a white cat wearing sunglasses "
               "sits on a surfboard.",
    "i2v-tiny": "a tiny test image-to-video",
}

def _validate_args(args):
    """The JAX CLI's checks (ref generate.py:34-60), raising instead of
    asserting."""
    if args.task not in WAN_CONFIGS:
        raise ValueError(f"task {args.task!r} is not served by the port")
    if args.sample_steps is None:
        args.sample_steps = 50
    if args.sample_shift is None:
        args.sample_shift = 5.0
    if args.frame_num is None:
        args.frame_num = 1 if "t2i" in args.task else 81
    if "t2i" in args.task:
        if args.frame_num != 1:
            raise ValueError("frame_num must be 1 for t2i")
    elif (args.frame_num - 1) % 4 != 0:
        raise ValueError("frame_num should be 4n+1 (ref generate.py:47-49)")
    if args.size not in SUPPORTED_SIZES[args.task]:
        raise ValueError(
            f"Unsupported size {args.size} for task {args.task}; "
            f"supported: {SUPPORTED_SIZES[args.task]}")
    if args.prompt is None:
        args.prompt = EXAMPLE_PROMPT[args.task]
    if "i2v" in args.task and args.image is None:
        raise ValueError("--image is required for i2v tasks")
    if args.ulysses_size < 1 or args.ring_size < 1:
        raise ValueError("--ulysses_size and --ring_size must be >= 1")


def load_image(path: str, size) -> np.ndarray:
    """The conditioning image as the JAX CLI reads it (generate.py:
    184-201): RGB, resized to ``size`` = (w, h) by PIL, [3, h, w] float32
    in [-1, 1]."""
    from PIL import Image

    im = Image.open(path).convert("RGB").resize(tuple(size))
    return np.asarray(im, np.float32).transpose(2, 0, 1) / 127.5 - 1.0


def _parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Generate a video from a text prompt (PyTorch/CUDA)")
    parser.add_argument("--task", type=str, default="t2v-14B",
                        choices=list(WAN_CONFIGS.keys()))
    parser.add_argument("--size", type=str, default="1280*720",
                        choices=list(SIZE_CONFIGS.keys()))
    parser.add_argument("--frame_num", type=int, default=None,
                        help="frames to generate (4n+1)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default: cuda)")
    parser.add_argument("--ckpt_dir", type=str, default=None,
                        help="checkpoint directory in the reference layout "
                             "(default: random weights)")
    parser.add_argument("--ulysses_size", type=int, default=1,
                        help="sequence-parallel (head all-to-all) degree")
    parser.add_argument("--ring_size", type=int, default=1,
                        help="ring-attention degree")
    parser.add_argument("--dit_fsdp", action="store_true", default=False,
                        help="shard DiT params across the mesh")
    parser.add_argument("--t5_fsdp", action="store_true", default=False,
                        help="shard T5 params across the mesh")
    parser.add_argument("--t5_cpu", action="store_true", default=False,
                        help="compatibility flag (no-op: the T5 stays on "
                             "the card)")
    parser.add_argument("--save_file", type=str, default=None)
    parser.add_argument("--prompt", type=str, default=None)
    parser.add_argument("--image", type=str, default=None)
    parser.add_argument("--use_prompt_extend", action="store_true",
                        default=False)
    parser.add_argument("--prompt_extend_method", type=str,
                        default="local_qwen",
                        choices=["dashscope", "local_qwen"])
    parser.add_argument("--prompt_extend_model", type=str, default=None)
    parser.add_argument("--prompt_extend_target_lang", type=str,
                        default="ch", choices=["ch", "en"])
    parser.add_argument("--base_seed", type=int, default=-1)
    parser.add_argument("--sample_solver", type=str, default="unipc",
                        choices=["unipc", "dpm++"])
    parser.add_argument("--sample_steps", type=int, default=None)
    parser.add_argument("--sample_shift", type=float, default=None)
    parser.add_argument("--sample_guide_scale", type=float, default=5.0)
    parser.add_argument("--offload_model", type=str2bool, default=None,
                        help="compatibility flag (no-op)")
    parser.add_argument("--quant", type=str, default=None,
                        choices=["int8", "int4", "w8a8"],
                        help="int8/int4: weight-only block linears; w8a8: "
                             "int8 weights and per-token int8 activations "
                             "through the int8 GEMM kernel")
    parser.add_argument("--residual_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="DiT residual-stream dtype")
    return parser.parse_args(argv)


def build_mesh(args):
    """The JAX CLI's mesh rules (generate.py:144-183) over the ranks of
    the process group (or over this process alone): (mesh or None,
    sp_mode). Ranks past the mesh get a None mesh and sit out."""
    from ..parallel import distributed
    from ..parallel.comm import thread_mesh
    from ..parallel.mesh import make_pod_mesh

    u, r = args.ulysses_size, args.ring_size
    sp_mode = "usp" if u > 1 and r > 1 else "ring" if r > 1 else "ulysses"
    sp = u * r
    if not (sp > 1 or args.dit_fsdp or args.t5_fsdp):
        return None, sp_mode
    dist_up = distributed.is_initialized()
    world = 1
    if dist_up:
        import torch.distributed as dist

        world = dist.get_world_size()
    if world % sp != 0:
        raise ValueError(f"sequence-parallel degree {sp} must divide the "
                         f"world size {world} (launch the ranks with "
                         "torchrun)")
    # the inference batch is the CFG pair, so the data axis is at most 2;
    # ranks beyond 2·sp sit out (the reference requires ulysses·ring ==
    # world_size for the same reason, generate.py:216-229)
    data = min(world // sp, 2)
    ring, seq = (r, u) if u > 1 and r > 1 else (1, sp)
    if not dist_up:  # one process alone: a one-rank mesh of its own
        mesh = thread_mesh()[0]
    else:
        mesh = make_pod_mesh(data=data, ring=ring, seq=seq)
    logging.info("mesh: data %d x ring %d x seq %d (%s)", data, ring, seq,
                 sp_mode)
    return mesh, sp_mode


def extend_prompt(args, device) -> str:
    """The prompt rewritten by ``--prompt_extend_method`` (the JAX CLI's
    ``generate.py:163-175``); on the rewriter's failure a warning and the
    prompt unchanged."""
    from ..utils.prompt_extend import build_prompt_expander

    expander = build_prompt_expander(
        args.prompt_extend_method, model_name=args.prompt_extend_model,
        task=args.task, device=device)
    out = expander(args.prompt, tar_lang=args.prompt_extend_target_lang,
                   seed=args.base_seed)
    if out.status:
        logging.info("extended prompt: %s", out.prompt)
        return out.prompt
    logging.warning("prompt extension failed: %s", out.message)
    return args.prompt


def generate(args) -> Optional[str]:
    """Run one request; returns the path written, or None on a rank that
    does not write (under a mesh, every rank but 0). Initializes
    ``torch.distributed`` first when launched by ``torchrun``, and takes
    the process group down again at the end if it brought it up."""
    from ..parallel import distributed

    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s] %(levelname)s: %(message)s")
    owned = not distributed.is_initialized()
    distributed.maybe_initialize_distributed(device=args.device)
    try:
        return _generate(args)
    finally:
        if owned and distributed.is_initialized():
            import torch.distributed as dist

            dist.destroy_process_group()


def _generate(args) -> Optional[str]:
    from ..parallel import distributed
    from ..pipelines.image2video import WanI2V
    from ..pipelines.text2video import WanT2V

    cfg = WAN_CONFIGS[args.task]
    size = SIZE_CONFIGS[args.size]
    mesh, sp_mode = build_mesh(args)
    if distributed.is_initialized():
        import torch.distributed as dist

        if mesh is None and (args.ulysses_size * args.ring_size > 1
                             or args.dit_fsdp or args.t5_fsdp):
            logging.info("rank %d is outside the mesh: nothing to do",
                         dist.get_rank())
            return None
        writer = dist.get_rank() == 0
    else:
        writer = True
    device = distributed.local_device(args.device)
    # Under a mesh the pipeline takes rank 0's token ids on every rank, so
    # only rank 0 rewrites the prompt: a rewrite cannot split the ranks.
    if args.use_prompt_extend and writer:
        args.prompt = extend_prompt(args, device)
    logging.info("prompt: %s", args.prompt)
    pipe_kw = dict(config=cfg, residual_dtype=args.residual_dtype,
                   device=device,
                   checkpoint_dir=args.ckpt_dir, quant=args.quant,
                   mesh=mesh, sp_mode=sp_mode)
    gen_kw = dict(size=size, frame_num=args.frame_num,
                  shift=args.sample_shift, sample_solver=args.sample_solver,
                  sampling_steps=args.sample_steps,
                  guide_scale=args.sample_guide_scale, seed=args.base_seed)
    if "i2v" in args.task:
        pipe = WanI2V(**pipe_kw)
        video = pipe.generate(args.prompt, load_image(args.image, size),
                              **gen_kw)
    else:
        pipe = WanT2V(**pipe_kw)
        video = pipe.generate(args.prompt, **gen_kw)
    logging.info("timings: %s", pipe.timings)
    if video is None or not writer:  # rank 0 writes
        return None

    if args.save_file is None:
        ts = datetime.now().strftime("%Y%m%d_%H%M%S")
        prompt_tag = args.prompt.replace(" ", "_").replace("/", "_")[:50]
        suffix = ".png" if "t2i" in args.task else ".mp4"
        args.save_file = (f"{args.task}_{args.size.replace('*', 'x')}_"
                          f"{prompt_tag}_{ts}{suffix}")
    if "t2i" in args.task:
        out = cache_image(video[:, 0], save_file=args.save_file)
    else:
        out = cache_video(video, save_file=args.save_file, fps=cfg.sample_fps)
    logging.info("finished: %s", out)
    return out


def main(argv=None):
    args = _parse_args(argv)
    _validate_args(args)
    return generate(args)


if __name__ == "__main__":
    main()
