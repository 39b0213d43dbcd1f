"""Text→video generation pipeline in PyTorch.

Counterpart of ``moviigen_tpu/pipelines/text2video.py::WanT2V`` (ref
``wan/text2video.py``): umT5 text encoding, the CFG-guided flow-matching
denoise loop around the DiT with UniPC (default) or DPM++, and the causal
3D VAE decode. Everything lives on one device; the 14B DiT (28 GB bf16),
the umT5-XXL encoder (11.6 GB) and the VAE fit one 80 GB card together,
so nothing is offloaded. Weights are random (made from ``init_seed``) or
carried from a JAX parameter tree with ``convert``.
"""

from __future__ import annotations

import logging
import math
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..configs import PipelineConfig
from ..diffusion import (FlowDPMSolverMultistepScheduler,
                         FlowUniPCMultistepScheduler, get_sampling_sigmas)
from ..models import vae as vaem
from ..models.t5 import T5Encoder
from ..models.tokenizer import load_tokenizer
from ..models.vae_streaming import decode_streaming
from ..models.wan_model import WanModel
from ..ops.rope import rope_3d_freqs

# Output pixels (frames × H × W) above which the decode streams over
# latent-frame chunks instead of decoding the clip as one tensor.
STREAMING_DECODE_PIXELS = 2 ** 24


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another. Raises when no CUDA device is present and none is
    named: the port does not carry on silently on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' (--device cpu) to run "
                "the port on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device


def compute_target_shape_and_seq_len(config: PipelineConfig,
                                     size: Tuple[int, int], frame_num: int):
    """Latent target shape, token seq_len and patch grid for a (W, H) size
    (ref text2video.py:160-166): 480×832 @ 81f → 32,760 tokens."""
    vs = config.vae_stride
    ps = config.model.patch_size
    target_shape = (config.vae.z_dim, (frame_num - 1) // vs[0] + 1,
                    size[1] // vs[1], size[0] // vs[2])
    seq_len = int(math.ceil((target_shape[2] * target_shape[3])
                            / (ps[1] * ps[2]) * target_shape[1]))
    grid = (target_shape[1] // ps[0], target_shape[2] // ps[1],
            target_shape[3] // ps[2])
    return target_shape, seq_len, grid


def cfg_batched(model_dim: int, seq_len: int) -> bool:
    """The JAX pipeline's CFG pairing rule (text2video.py:604): one B=2
    forward while the doubled activations stay small, else cond and
    uncond as two B=1 forwards."""
    return 2 * 2 * seq_len * (3 * model_dim) <= (1 << 30)


class WanT2V:
    """Owns the DiT, the T5 encoder and the VAE on one device and
    generates videos."""

    def __init__(self, config: PipelineConfig, init_seed: int = 0,
                 attn_backend: str = "auto",
                 residual_dtype: str = "float32", device=None,
                 checkpoint_dir=None):
        if checkpoint_dir is not None:
            raise NotImplementedError(
                "WanT2V(checkpoint_dir=...) needs the T5 and VAE converters "
                "(ROADMAP queue 1 item 0); the port loads the DiT alone "
                "(models.wan_convert.load_wan_checkpoint)")
        if residual_dtype not in ("float32", "bfloat16"):
            raise ValueError("residual_dtype must be float32|bfloat16, "
                             f"got {residual_dtype!r}")
        self.device = resolve_device(device)
        self.config = config
        self.attn_backend = attn_backend
        self.residual_dtype = getattr(torch, residual_dtype)
        self.sample_neg_prompt = config.sample_neg_prompt
        self.timings = {}

        logging.warning("random-init params from seed %d (no checkpoint "
                        "loader in the port yet)", init_seed)
        gen = torch.Generator(device=self.device).manual_seed(init_seed)
        with torch.no_grad():
            self.t5 = T5Encoder(config.t5, dtype=getattr(torch, config.t5_dtype),
                                device=self.device).init_weights(gen).eval()
            self.vae_params = vaem.init_params(config.vae, gen,
                                               device=self.device)
            self.dit = WanModel(config.model, dtype=config.torch_param_dtype,
                                device=self.device).init_weights(gen).eval()
        self.tokenizer = load_tokenizer(
            config.t5_tokenizer, seq_len=config.model.text_len,
            clean="whitespace", vocab_size=config.t5.vocab_size)

    # ------------------------------------------------------------------

    @torch.no_grad()
    def encode_text(self, texts) -> torch.Tensor:
        """Prompt(s) → [B, text_len, t5_dim], exact zeros past each true
        length (ref t5.py:516-518 + model.py:549-554)."""
        if isinstance(texts, str):
            texts = [texts]
        ids, mask = self.tokenizer(texts, return_mask=True,
                                   add_special_tokens=True)
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.long,
                              device=self.device)
        mask = torch.as_tensor(np.asarray(mask), dtype=torch.long,
                               device=self.device)
        ctx = self.t5(ids, mask)
        return ctx * mask[..., None].to(ctx.dtype)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def decode(self, latent: torch.Tensor) -> torch.Tensor:
        """Latents [B, z, T', H', W'] → video [B, 3, T, H, W], decoded in
        the config's decode dtype and returned as fp32; streams above
        STREAMING_DECODE_PIXELS output pixels."""
        cfg = self.config
        z = latent.to(getattr(torch, cfg.vae_decode_dtype))
        t, h, w = z.shape[2], z.shape[3] * 8, z.shape[4] * 8
        frames = 1 + (t - 1) * 4
        if frames * h * w > STREAMING_DECODE_PIXELS:
            out = decode_streaming(self.vae_params, z, cfg.vae)
        else:
            out = vaem.decode(self.vae_params, z, cfg.vae)
        return out.float()

    @torch.no_grad()
    def generate(self, input_prompt: str,
                 size: Tuple[int, int] = (1280, 720),
                 frame_num: int = 81,
                 shift: float = 5.0,
                 sample_solver: str = "unipc",
                 sampling_steps: int = 50,
                 guide_scale: float = 5.0,
                 n_prompt: str = "",
                 seed: int = -1,
                 noise: Optional[np.ndarray] = None,
                 return_latents: bool = False) -> np.ndarray:
        """Generate a video (ref WanT2V.generate, text2video.py:114-271).

        Returns [C, F, H, W] numpy float32 in [-1, 1], or the final latent
        [z, F', H', W'] with ``return_latents``. ``noise`` replaces the
        seeded initial latent. Per-phase seconds land in ``self.timings``
        (t5_s, step_s list, decode_s)."""
        cfg = self.config
        target_shape, seq_len, grid = compute_target_shape_and_seq_len(
            cfg, size, frame_num)
        if n_prompt == "":
            n_prompt = self.sample_neg_prompt
        if seed < 0:
            seed = int.from_bytes(os.urandom(4), "little")
        timings = {"step_s": []}
        self.timings = timings

        t0 = time.perf_counter()
        ctx_pair = self.encode_text([input_prompt, n_prompt])
        self._sync()
        timings["t5_s"] = time.perf_counter() - t0

        if noise is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            latent = torch.randn((1, *target_shape), generator=gen,
                                 dtype=torch.float32, device=self.device)
        else:
            latent = torch.as_tensor(np.asarray(noise, np.float32),
                                     device=self.device).reshape(
                                         1, *target_shape)

        if sample_solver == "unipc":
            scheduler = FlowUniPCMultistepScheduler(
                num_train_timesteps=cfg.num_train_timesteps, shift=1.0)
            scheduler.set_timesteps(sampling_steps, shift=shift)
        elif sample_solver == "dpm++":
            scheduler = FlowDPMSolverMultistepScheduler(
                num_train_timesteps=cfg.num_train_timesteps, shift=1.0)
            scheduler.set_timesteps(
                sampling_steps,
                sigmas=get_sampling_sigmas(sampling_steps, shift))
        else:
            raise NotImplementedError(f"Unsupported solver: {sample_solver}")

        rope = rope_3d_freqs(grid, cfg.model.head_dim, device=self.device)
        batched = cfg_batched(cfg.model.dim, seq_len)

        def fwd(x, t, ctx):
            return self.dit(x, t, ctx, rope, seq_len=seq_len,
                            attn_backend=self.attn_backend,
                            residual_dtype=self.residual_dtype)

        logging.info("denoising: %d %s steps at %d tokens (%s CFG)",
                     sampling_steps, sample_solver, seq_len,
                     "batched" if batched else "sequential")
        state = scheduler.init_state(latent)
        for i, t in enumerate(scheduler.timesteps):
            ts = time.perf_counter()
            t_dev = torch.full((1,), float(t), dtype=torch.float32,
                               device=self.device)
            if batched:
                pred = fwd(latent.expand(2, *target_shape), t_dev.expand(2),
                           ctx_pair)
                cond, uncond = pred[:1], pred[1:]
            else:
                cond = fwd(latent, t_dev, ctx_pair[:1])
                uncond = fwd(latent, t_dev, ctx_pair[1:])
            noise_pred = uncond + guide_scale * (cond - uncond)
            latent, state = scheduler.step(noise_pred, i, latent, state)
            self._sync()
            timings["step_s"].append(time.perf_counter() - ts)

        if return_latents:
            return latent[0].cpu().numpy()

        t0 = time.perf_counter()
        video = self.decode(latent)
        self._sync()
        timings["decode_s"] = time.perf_counter() - t0
        return video[0].cpu().numpy()
