"""Memory-bounded streaming VAE encode and decode.

Counterpart of ``moviigen_tpu/models/vae_streaming.py::encode_streaming``
and ``::decode_streaming``: the first frame, then chunks of frames, go
through the encoder (4 video frames a chunk) or the decoder (latent
frames) with explicit per-conv time caches, so activation memory is that
of one chunk instead of the whole clip. Cache rules:

- stride-1 causal k3 conv: carry the last 2 input frames at that layer
  (zeros before the first chunk);
- encoder downsample3d time conv: the first chunk bypasses the conv;
  every chunk leaves its last input frame;
- decoder upsample3d time conv: the first chunk bypasses the conv and
  leaves a 2-frame zero cache (the 'Rep' lead-in); later chunks carry
  their last 2 input frames.

The results equal the full-tensor ``vae.encode`` and ``vae.decode``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from ..configs import VAEConfig
from . import vae as vaem
from .vae import (_interleave_time, _spatial_down, _spatial_up,
                  attention_block, causal_conv3d, denormalize_latents,
                  normalize_latents, vae_rms_norm)

Params = Dict[str, Any]

# Input pixels (frames × H × W) above which ``encode_video`` streams: the
# pipeline's decode threshold. At the dataset's 1920×832×81 crops one
# full-tensor activation of the first stage is 25 GB in bf16.
STREAMING_ENCODE_PIXELS = 2 ** 24


class _CacheIO:
    """Sequential cache reader/writer walked in layer order."""

    def __init__(self, caches: Optional[List[torch.Tensor]]):
        self.in_caches = caches
        self.out: List[torch.Tensor] = []
        self.i = 0

    def next(self, like: torch.Tensor) -> torch.Tensor:
        """The cache of the next layer: what it put on the chunk before,
        or 2 zero frames shaped like ``like`` on the first chunk."""
        if self.in_caches is None:
            c = like.new_zeros((like.shape[0], like.shape[1], 2,
                                *like.shape[3:]))
        else:
            c = self.in_caches[self.i]
        self.i += 1
        return c

    def put(self, c: torch.Tensor) -> None:
        """Keep a copy of ``c`` for the next chunk: a view of the layer's
        input would hold all of that input alive until then."""
        self.out.append(c.clone())


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


def _sdown3d_time(p: Params, x: torch.Tensor, io: _CacheIO,
                  first: bool) -> torch.Tensor:
    """Streaming temporal stride-2 conv: the first chunk bypasses it;
    later chunks prepend the previous chunk's last frame."""
    if first:
        io.put(x[:, :, -1:])
        return x
    inp = torch.cat([io.next(x), x], dim=2)
    out = causal_conv3d(p, inp, stride=(2, 1, 1), time_pad=0, space_pad=0)
    io.put(inp[:, :, -1:])
    return out


def _sup3d_time(p: Params, x: torch.Tensor, io: _CacheIO,
                first: bool) -> torch.Tensor:
    if first:
        io.put(x.new_zeros((x.shape[0], x.shape[1], 2, *x.shape[3:])))
        return x
    inp = torch.cat([io.next(x), x], dim=2)
    y = causal_conv3d(p, inp, time_pad=0, space_pad=0)  # [B, 2C, t, H, W]
    io.put(inp[:, :, -2:])
    return _interleave_time(y)


def _encoder_chunk(p: Params, x: torch.Tensor, caches, first: bool):
    io = _CacheIO(None if first else caches)
    h = _sconv(p["conv1"], x, io)
    for stage in p["down"]:
        for rb in stage["res"]:
            h = _sres(rb, h, io)
        if "downsample" in stage:
            ds = stage["downsample"]
            h = _spatial_down(ds["conv"], h)
            if "time_conv" in ds:
                h = _sdown3d_time(ds["time_conv"], h, io, first)
    h = _sres(p["mid_res1"], h, io)
    h = attention_block(p["mid_attn"], h)
    h = _sres(p["mid_res2"], h, io)
    h = vae_rms_norm(p["head_norm"], h)
    return _sconv(p["head_conv"], F.silu(h), io), io.out


def encode_streaming(params: Params, video: torch.Tensor,
                     cfg: VAEConfig) -> torch.Tensor:
    """Video [B, 3, T, H, W] → normalized latents [B, z, T', H/8, W/8],
    encoding the first frame alone and then 4 frames per step (the
    reference's chunking, vae.py:519-534). T must be 4n+1."""
    t = video.shape[2]
    if (t - 1) % 4:
        raise ValueError(f"streaming encode needs 4n+1 frames, got {t}")
    out, caches = _encoder_chunk(params["encoder"], video[:, :, :1], None,
                                 first=True)
    outs = [out]
    for s in range(1, t, 4):
        out, caches = _encoder_chunk(params["encoder"],
                                     video[:, :, s:s + 4], caches,
                                     first=False)
        outs.append(out)
    h = causal_conv3d(params["conv1"], torch.cat(outs, dim=2))
    return normalize_latents(h, cfg)


def encode_video(params: Params, video: torch.Tensor,
                 cfg: VAEConfig) -> torch.Tensor:
    """``vae.encode``, or ``encode_streaming`` above
    STREAMING_ENCODE_PIXELS input pixels (the same latents in less
    memory)."""
    t, h, w = video.shape[2:]
    if t * h * w > STREAMING_ENCODE_PIXELS:
        return encode_streaming(params, video, cfg)
    return vaem.encode(params, video, cfg)


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
