"""Memory-bounded streaming VAE decode.

Counterpart of ``moviigen_tpu/models/vae_streaming.py::decode_streaming``:
the first latent frame, then chunks of latent frames, go through the
decoder with explicit per-conv time caches, so activation memory is that
of one chunk instead of the whole clip. Cache rules:

- stride-1 causal k3 conv: carry the last 2 input frames at that layer
  (zeros before the first chunk);
- upsample3d time conv: the first chunk bypasses the conv and leaves a
  2-frame zero cache (the 'Rep' lead-in); later chunks carry their last
  2 input frames.

The result equals the full-tensor ``vae.decode``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from ..configs import VAEConfig
from .vae import (_interleave_time, _spatial_up, attention_block,
                  causal_conv3d, denormalize_latents, vae_rms_norm)

Params = Dict[str, Any]


class _CacheIO:
    """Sequential cache reader/writer walked in layer order."""

    def __init__(self, caches: Optional[List[torch.Tensor]]):
        self.in_caches = caches
        self.out: List[torch.Tensor] = []
        self.i = 0

    def next(self, like: torch.Tensor) -> torch.Tensor:
        """The cache of the next layer: 2 zero frames shaped like ``like``
        on the first chunk."""
        if self.in_caches is None:
            c = like.new_zeros((like.shape[0], like.shape[1], 2,
                                *like.shape[3:]))
        else:
            c = self.in_caches[self.i]
        self.i += 1
        return c

    def put(self, c: torch.Tensor) -> None:
        self.out.append(c)


def _sconv(p: Params, x: torch.Tensor, io: _CacheIO) -> torch.Tensor:
    """Streaming stride-1 causal conv: prepend the 2-frame cache, no time
    padding, keep the last 2 input frames."""
    if p["weight"].shape[2] == 1:
        return causal_conv3d(p, x)
    inp = torch.cat([io.next(x), x], dim=2)
    out = causal_conv3d(p, inp, time_pad=0)
    io.put(inp[:, :, -2:])
    return out


def _sres(p: Params, x: torch.Tensor, io: _CacheIO) -> torch.Tensor:
    h = causal_conv3d(p["shortcut"], x) if "shortcut" in p else x
    y = _sconv(p["conv1"], F.silu(vae_rms_norm(p["norm1"], x)), io)
    y = _sconv(p["conv2"], F.silu(vae_rms_norm(p["norm2"], y)), io)
    return y + h


def _sup3d_time(p: Params, x: torch.Tensor, io: _CacheIO,
                first: bool) -> torch.Tensor:
    if first:
        io.put(x.new_zeros((x.shape[0], x.shape[1], 2, *x.shape[3:])))
        return x
    inp = torch.cat([io.next(x), x], dim=2)
    y = causal_conv3d(p, inp, time_pad=0, space_pad=0)  # [B, 2C, t, H, W]
    io.put(inp[:, :, -2:])
    return _interleave_time(y)


def _decoder_chunk(p: Params, z: torch.Tensor, caches, first: bool):
    io = _CacheIO(None if first else caches)
    h = _sconv(p["conv1"], z, io)
    h = _sres(p["mid_res1"], h, io)
    h = attention_block(p["mid_attn"], h)
    h = _sres(p["mid_res2"], h, io)
    for stage in p["up"]:
        for rb in stage["res"]:
            h = _sres(rb, h, io)
        if "upsample" in stage:
            us = stage["upsample"]
            if "time_conv" in us:
                h = _sup3d_time(us["time_conv"], h, io, first)
            h = _spatial_up(us, h)
    h = vae_rms_norm(p["head_norm"], h)
    return _sconv(p["head_conv"], F.silu(h), io), io.out


def default_chunk_frames(t: int, h_out: int, w_out: int,
                         cfg: VAEConfig) -> int:
    """The JAX package's rule (vae_streaming.py:221-232): the largest
    divisor of T'-1 up to 5 whose chunk keeps ~4 full-resolution fp32
    buffers under 2 GB."""
    rest = t - 1
    per_chunk_frame = 4 * h_out * w_out * cfg.dim * 4 * 4
    c_max = max(1, int((2 << 30) // per_chunk_frame))
    for c in range(min(5, c_max, max(rest, 1)), 0, -1):
        if rest % c == 0:
            return c
    return 1


def decode_streaming(params: Params, z: torch.Tensor, cfg: VAEConfig,
                     chunk_frames: Optional[int] = None) -> torch.Tensor:
    """Normalized latents [B, z, T', H', W'] → video [B, 3, T, 8H', 8W'],
    decoding ``chunk_frames`` latent frames per step after the first."""
    zl = causal_conv3d(params["conv2"], denormalize_latents(z, cfg))
    t = zl.shape[2]
    rest = t - 1
    if chunk_frames is None:
        chunk_frames = default_chunk_frames(t, zl.shape[3] * 8,
                                            zl.shape[4] * 8, cfg)
    if rest % chunk_frames:
        raise ValueError(f"chunk_frames {chunk_frames} must divide T'-1 = "
                         f"{rest}")
    out, caches = _decoder_chunk(params["decoder"], zl[:, :, :1], None,
                                 first=True)
    outs = [out]
    for s in range(1, t, chunk_frames):
        out, caches = _decoder_chunk(params["decoder"],
                                     zl[:, :, s:s + chunk_frames], caches,
                                     first=False)
        outs.append(out)
    return torch.cat(outs, dim=2).clamp(-1.0, 1.0)
