"""Image→video conditioning and pipeline (the i2v model variant) in
PyTorch.

Counterpart of ``moviigen_tpu/pipelines/image2video.py``:

- ``build_i2v_mask`` / ``build_i2v_conditioning``: the conditioning that
  the reference builds in preprocessing (``preprocess_wan_dataset.py:
  489-536``): the first-frame mask repeated 4× and folded onto the latent
  time grid, the VAE encoding of [image, zeros × (F − 1)], and the CLIP's
  31st-block features of the raw image;
- ``WanI2V``: ``WanT2V`` plus the CLIP tower, whose ``generate`` feeds
  ``clip_fea`` and ``y`` to the i2v DiT (in_dim = 16 latent + 20
  conditioning channels) under the same CFG rule; with ``mesh`` and
  ``sp_mode`` as one rank of a sequence-parallel group, as ``WanT2V``
  (the 257-key image cross-attention stays local to each rank's tokens).

Everything lives on one device beside the t2v pipeline's models: the fp32
ViT-H/14 adds 2.5 GB. The conditioning video is encoded in fp32 (the
image's dtype) through ``encode_video``, which streams above
``STREAMING_ENCODE_PIXELS`` input pixels: 832×480×81 and 1280×720×81 do,
where the JAX package encodes the clip as one tensor (the same latents,
within 1e-3 in fp32).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..configs import PipelineConfig
from ..models import clip as clipm
from ..models.vae_streaming import encode_video
from ..ops.resize import resize_bicubic
from .text2video import WanT2V


def build_i2v_mask(frames: int, lat_h: int, lat_w: int,
                   device=None) -> torch.Tensor:
    """First-frame conditioning mask folded into the latent grid (ref
    preprocess_wan_dataset.py:506-513): [4, (F − 1)/4 + 1, lat_h, lat_w]
    fp32, ones on the first latent frame."""
    msk = torch.zeros((1, frames, lat_h, lat_w), dtype=torch.float32,
                      device=device)
    msk[:, 0] = 1.0
    msk = torch.cat([msk[:, 0:1].repeat(1, 4, 1, 1), msk[:, 1:]], dim=1)
    t4 = msk.shape[1] // 4
    return msk.reshape(1, t4, 4, lat_h, lat_w).permute(0, 2, 1, 3, 4)[0]


@torch.no_grad()
def encode_conditioning_video(vae_params, image: torch.Tensor, frames: int,
                              size: Tuple[int, int], vae_cfg
                              ) -> torch.Tensor:
    """``y`` [4 + z, T', h/8, w/8] fp32: the mask, then the VAE latents of
    [image resized to ``size`` = (w, h), zeros × (frames − 1)], encoded in
    the image's dtype."""
    w, h = size
    img = resize_bicubic(image, (h, w))
    vid = torch.cat([img[:, None], img.new_zeros((3, frames - 1, h, w))],
                    dim=1)
    y_lat = encode_video(vae_params, vid[None], vae_cfg)[0]
    msk = build_i2v_mask(frames, h // 8, w // 8, device=image.device)
    return torch.cat([msk, y_lat.float()], dim=0)


@torch.no_grad()
def build_i2v_conditioning(vae_params, clip: clipm.CLIPVision,
                           image: torch.Tensor, frames: int,
                           size: Tuple[int, int], vae_cfg):
    """image: [3, H, W] in [-1, 1] → (y [4 + z, T', h/8, w/8] fp32,
    clip_fea [1, 257, 1280]); the CLIP sees the raw (un-resized) image
    (the JAX ``build_i2v_conditioning``, image2video.py:45-65)."""
    y = encode_conditioning_video(vae_params, image, frames, size, vae_cfg)
    return y, clipm.visual_features(clip, image[None])


class WanI2V(WanT2V):
    """Image→video pipeline: ``WanT2V`` plus the CLIP tower and the
    conditioned forward (clip_fea + the y channel concat, ref
    model.py:516-524). The CLIP comes from ``clip_checkpoint`` in
    ``checkpoint_dir`` or, without one, is random from a generator seeded
    with ``init_seed`` + 2 (the preprocessing CLIs' rule for it)."""

    def __init__(self, config: PipelineConfig, init_seed: int = 0,
                 attn_backend: str = "auto",
                 residual_dtype: str = "float32", device=None,
                 checkpoint_dir: Optional[str] = None,
                 quant: Optional[str] = None, prompt_cache: bool = True,
                 clip_checkpoint: str = clipm.CLIP_CHECKPOINT,
                 mesh=None, sp_mode: str = "ulysses"):
        if config.model.model_type != "i2v":
            raise ValueError(f"WanI2V needs an i2v model config, got "
                             f"{config.name} ({config.model.model_type})")
        super().__init__(config, init_seed=init_seed,
                         attn_backend=attn_backend,
                         residual_dtype=residual_dtype, device=device,
                         checkpoint_dir=checkpoint_dir, quant=quant,
                         prompt_cache=prompt_cache, mesh=mesh,
                         sp_mode=sp_mode)
        self.clip_cfg = clipm.CLIPVisionConfig()
        path = (os.path.join(checkpoint_dir, clip_checkpoint)
                if checkpoint_dir is not None else None)
        if path is not None and os.path.exists(path):
            self.clip = clipm.load_clip_checkpoint(path, self.clip_cfg,
                                                   device=self.device)
        else:
            logging.warning("random-init CLIP tower (no checkpoint)")
            gen = torch.Generator(device=self.device).manual_seed(
                init_seed + 2)
            self.clip = clipm.CLIPVision(
                self.clip_cfg, device=self.device).init_weights(gen)
        self.clip.eval()

    @torch.no_grad()
    def generate(self, input_prompt: str, image: np.ndarray,
                 size: Tuple[int, int] = (1280, 720),
                 frame_num: int = 81, shift: float = 5.0,
                 sample_solver: str = "unipc", sampling_steps: int = 40,
                 guide_scale: float = 5.0, n_prompt: str = "",
                 seed: int = -1, noise: Optional[np.ndarray] = None,
                 return_latents: bool = False) -> Optional[np.ndarray]:
        """image: [3, H, W] float in [-1, 1]. Returns [C, F, H, W] numpy
        float32 in [-1, 1], or the final latent with ``return_latents``
        (the JAX ``WanI2V.generate``); under a mesh as ``WanT2V.generate``
        (every rank conditions and denoises, rank 0 decodes). ``self.timings`` adds encode_s (the
        conditioning video's VAE encode) and clip_s to t2v's."""
        ctx_pair = self._start_request(input_prompt, n_prompt)
        image = torch.as_tensor(np.asarray(image, np.float32),
                                device=self.device)
        t0 = time.perf_counter()
        y = encode_conditioning_video(self.vae_params, image, frame_num,
                                      size, self.config.vae)
        self._sync()
        self.timings["encode_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        clip_fea = clipm.visual_features(self.clip, image[None],
                                         backend=self.attn_backend)
        self._sync()
        self.timings["clip_s"] = time.perf_counter() - t0
        latent = self._sample(ctx_pair, size, frame_num, shift,
                              sample_solver, sampling_steps, guide_scale,
                              seed, noise, clip_fea=clip_fea, y=y[None])
        if return_latents:
            return latent[0].cpu().numpy()
        return self.decode_request(latent)
