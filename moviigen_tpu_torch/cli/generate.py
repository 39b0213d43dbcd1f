"""Text→video and image→video generation CLI of the PyTorch port.

Counterpart of ``moviigen_tpu/cli/generate.py`` for the t2v, t2i and i2v
tasks, on one device (``--device``, default ``cuda``). Flags of later
slices of the port are accepted by the parser and refused with an error
naming the slice that brings them.

Examples:
    python -m moviigen_tpu_torch.cli.generate --task t2v-14B \\
        --size 832*480 --frame_num 17 --sample_steps 4 --quant w8a8
    python -m moviigen_tpu_torch.cli.generate --task i2v-14B \\
        --size 832*480 --image first_frame.png

``--image`` (i2v, required there) is read as the JAX CLI reads it: RGB,
resized to the request's size, scaled to [-1, 1].

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

# flag → (value that means "not used", slice of the port that brings it)
LATER_SLICE_FLAGS = {
    "ulysses_size": (1, "the multi-GPU sequence-parallel slice"),
    "ring_size": (1, "the multi-GPU sequence-parallel slice"),
    "dit_fsdp": (False, "the multi-GPU sequence-parallel slice"),
    "t5_fsdp": (False, "the multi-GPU sequence-parallel slice"),
    "use_prompt_extend": (False, "the apps-and-utilities slice"),
}


def _validate_args(args):
    """The JAX CLI's checks (ref generate.py:34-60), raising instead of
    asserting, plus the refusal of later slices' flags."""
    if args.task not in WAN_CONFIGS:
        raise ValueError(f"task {args.task!r} is not served by the port")
    for flag, (unused, slice_name) in LATER_SLICE_FLAGS.items():
        if getattr(args, flag) != unused:
            raise NotImplementedError(
                f"--{flag} is not supported by the PyTorch port yet; it "
                f"comes with {slice_name}")
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
    parser.add_argument("--ulysses_size", type=int, default=1)
    parser.add_argument("--ring_size", type=int, default=1)
    parser.add_argument("--dit_fsdp", action="store_true", default=False)
    parser.add_argument("--t5_fsdp", action="store_true", default=False)
    parser.add_argument("--t5_cpu", action="store_true", default=False,
                        help="compatibility flag (no-op: the T5 stays on "
                             "the card)")
    parser.add_argument("--save_file", type=str, default=None)
    parser.add_argument("--prompt", type=str, default=None)
    parser.add_argument("--image", type=str, default=None)
    parser.add_argument("--use_prompt_extend", action="store_true",
                        default=False)
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


def generate(args) -> str:
    from ..pipelines.image2video import WanI2V
    from ..pipelines.text2video import WanT2V

    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s] %(levelname)s: %(message)s")
    cfg = WAN_CONFIGS[args.task]
    size = SIZE_CONFIGS[args.size]
    logging.info("prompt: %s", args.prompt)
    pipe_kw = dict(config=cfg, residual_dtype=args.residual_dtype,
                   device=args.device, checkpoint_dir=args.ckpt_dir,
                   quant=args.quant)
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
