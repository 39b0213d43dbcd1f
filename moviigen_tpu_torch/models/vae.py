"""Wan 3D causal VAE decoder in PyTorch.

Counterpart of ``moviigen_tpu/models/vae.py::decode`` (ref
``wan/modules/vae.py`` Decoder3d): 8×8 spatial, 4× temporal
decompression, causal 3D convolutions throughout, full-tensor temporal
ops equivalent to the reference's streaming caches.

Layout: NCDHW inside (``[B, C, T, H, W]``, PyTorch's convolution
layout), which is also the public layout. Parameters are a nested dict of
tensors with the JAX parameter tree's names and PyTorch weight layouts:
conv3d ``[O, I, kt, kh, kw]``, conv2d ``[O, I, kh, kw]``.

fp32 convolutions on the card must run with TF32 off
(``torch.backends.cudnn.allow_tf32 = False``) to match the JAX package's
``Precision.HIGHEST``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs import VAEConfig

Params = Dict[str, Any]

# hard-coded published latent normalization (ref vae.py:629-639)
LATENT_MEAN = (
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
)
LATENT_STD = (
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
)


# --------------------------------------------------------------------------
# primitive ops (NCDHW)
# --------------------------------------------------------------------------


def causal_conv3d(p: Params, x: torch.Tensor,
                  stride: Tuple[int, int, int] = (1, 1, 1),
                  time_pad: Optional[int] = None,
                  space_pad: Optional[int] = None) -> torch.Tensor:
    """Causal 3D conv: left-only zero padding in time (2·pad frames),
    symmetric in space (ref CausalConv3d, vae.py:17-36).
    p['weight']: [O, I, kt, kh, kw]; x: [B, C, T, H, W]."""
    kt, kh = p["weight"].shape[2:4]
    if time_pad is None:
        time_pad = 2 * ((kt - 1) // 2)
    if space_pad is None:
        space_pad = (kh - 1) // 2
    x = F.pad(x, (space_pad, space_pad, space_pad, space_pad, time_pad, 0))
    out = F.conv3d(x, p["weight"].to(x.dtype), None, stride)
    return out + p["bias"].to(x.dtype).view(1, -1, 1, 1, 1)


def conv2d(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Per-frame 2D conv with 'SAME' padding: x [B, C, T, H, W], weight
    [O, I, kh, kw]."""
    b, c, t, h, w = x.shape
    xf = x.transpose(1, 2).reshape(b * t, c, h, w)
    kh = p["weight"].shape[2]
    out = F.conv2d(xf, p["weight"].to(x.dtype), None,
                   padding=(kh - 1) // 2)
    out = out + p["bias"].to(x.dtype).view(1, -1, 1, 1)
    return out.reshape(b, t, -1, h, w).transpose(1, 2)


def vae_rms_norm(p: Params, x: torch.Tensor) -> torch.Tensor:
    """RMS_norm (ref vae.py:39-54): F.normalize over channels × sqrt(C) ×
    gamma, in fp32."""
    c = x.shape[1]
    xf = x.float()
    norm = xf.square().sum(dim=1, keepdim=True).sqrt()
    normed = xf / norm.clamp_min(1e-12)
    gamma = p["gamma"].float().view(1, -1, 1, 1, 1)
    return (normed * math.sqrt(c) * gamma).to(x.dtype)


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------


def residual_block(p: Params, x: torch.Tensor) -> torch.Tensor:
    """ref ResidualBlock (vae.py:186-220)."""
    h = causal_conv3d(p["shortcut"], x) if "shortcut" in p else x
    y = causal_conv3d(p["conv1"], F.silu(vae_rms_norm(p["norm1"], x)))
    y = causal_conv3d(p["conv2"], F.silu(vae_rms_norm(p["norm2"], y)))
    return y + h


def attention_block(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Single-head per-frame spatial attention (ref vae.py:223-262). Plain
    matmul/softmax, one frame at a time so the fp32 logits stay at
    [H·W, H·W]."""
    b, c, t, h, w = x.shape
    qkv = conv2d(p["to_qkv"], vae_rms_norm(p["norm"], x))
    qkv = qkv.transpose(1, 2).reshape(b * t, 3 * c, h * w)
    out = torch.empty((b * t, h * w, c), dtype=x.dtype, device=x.device)
    for i in range(b * t):
        q, k, v = qkv[i].transpose(0, 1).split(c, dim=1)    # [HW, C] each
        logits = torch.matmul(q.float(), k.float().transpose(0, 1))
        probs = torch.softmax(logits * (c ** -0.5), dim=-1).to(v.dtype)
        out[i] = torch.matmul(probs, v)
    out = out.reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)
    return conv2d(p["proj"], out) + x


def _spatial_up(p: Params, x: torch.Tensor) -> torch.Tensor:
    """2× nearest upsample + 3×3 conv C→C/2 (ref vae.py:76-83)."""
    up = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
    return conv2d(p["conv"], up)


def upsample3d_time(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Temporal 2× via a channel-doubling causal conv with a first-frame
    bypass — the full-tensor equivalent of the 'Rep' streaming path (ref
    vae.py:103-137)."""
    b, c, t, h, w = x.shape
    first = x[:, :, :1]
    if t == 1:
        return first
    y = causal_conv3d(p, x[:, :, 1:], time_pad=2, space_pad=0)  # [B,2C,T-1,H,W]
    return torch.cat([first, _interleave_time(y)], dim=2)


def _interleave_time(y: torch.Tensor) -> torch.Tensor:
    """[B, 2C, T, H, W] → [B, C, 2T, H, W]: channel half k of step i is
    output frame 2i + k."""
    b, c2, t, h, w = y.shape
    y = y.view(b, 2, c2 // 2, t, h, w).permute(0, 2, 3, 1, 4, 5)
    return y.reshape(b, c2 // 2, 2 * t, h, w)


def decoder(p: Params, z: torch.Tensor, cfg: VAEConfig) -> torch.Tensor:
    """Decoder3d (ref vae.py:369-472). z: [B, z, T', H', W'] →
    [B, 3, T, 8H', 8W']."""
    h = causal_conv3d(p["conv1"], z)
    h = residual_block(p["mid_res1"], h)
    h = attention_block(p["mid_attn"], h)
    h = residual_block(p["mid_res2"], h)
    for stage in p["up"]:
        for rb in stage["res"]:
            h = residual_block(rb, h)
        if "upsample" in stage:
            us = stage["upsample"]
            if "time_conv" in us:
                h = upsample3d_time(us["time_conv"], h)
            h = _spatial_up(us, h)
    h = vae_rms_norm(p["head_norm"], h)
    return causal_conv3d(p["head_conv"], F.silu(h))


def denormalize_latents(z: torch.Tensor, cfg: VAEConfig) -> torch.Tensor:
    """z·std + mean per latent channel ([B, z, T, H, W])."""
    mean = torch.tensor(LATENT_MEAN[:cfg.z_dim], dtype=z.dtype,
                        device=z.device).view(1, -1, 1, 1, 1)
    std = torch.tensor(LATENT_STD[:cfg.z_dim], dtype=z.dtype,
                       device=z.device).view(1, -1, 1, 1, 1)
    return z * std + mean


def decode(params: Params, z: torch.Tensor, cfg: VAEConfig) -> torch.Tensor:
    """Normalized latent [B, z, T', H', W'] → video [B, 3, T, 8H', 8W']
    clamped to [-1, 1] (ref vae.py:657-663)."""
    zl = causal_conv3d(params["conv2"], denormalize_latents(z, cfg))
    return decoder(params["decoder"], zl, cfg).clamp(-1.0, 1.0)


# --------------------------------------------------------------------------
# initialization (decoder side: what serving runs)
# --------------------------------------------------------------------------


def _conv(gen, kt, kh, kw, cin, cout, device):
    std = 1.0 / math.sqrt(kt * kh * kw * cin)
    wt = torch.empty((cout, cin, kt, kh, kw), dtype=torch.float32,
                     device=device).uniform_(-std, std, generator=gen)
    return {"weight": wt,
            "bias": torch.zeros(cout, dtype=torch.float32, device=device)}


def _conv2d(gen, kh, kw, cin, cout, device):
    p = _conv(gen, 1, kh, kw, cin, cout, device)
    return {"weight": p["weight"][:, :, 0], "bias": p["bias"]}


def _gamma(c, device):
    return {"gamma": torch.ones(c, dtype=torch.float32, device=device)}


def _res(gen, cin, cout, device):
    p = {"norm1": _gamma(cin, device),
         "conv1": _conv(gen, 3, 3, 3, cin, cout, device),
         "norm2": _gamma(cout, device),
         "conv2": _conv(gen, 3, 3, 3, cout, cout, device)}
    if cin != cout:
        p["shortcut"] = _conv(gen, 1, 1, 1, cin, cout, device)
    return p


def _attn(gen, c, device):
    return {"norm": _gamma(c, device),
            "to_qkv": _conv2d(gen, 1, 1, c, 3 * c, device),
            # zero-init proj (ref vae.py:238)
            "proj": {"weight": torch.zeros((c, c, 1, 1), device=device),
                     "bias": torch.zeros(c, device=device)}}


def _init_encoder(cfg: VAEConfig, gen, device) -> Params:
    dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
    enc: Params = {"conv1": _conv(gen, 3, 3, 3, 3, dims[0], device)}
    down = []
    for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
        stage: Params = {"res": []}
        c = cin
        for _ in range(cfg.num_res_blocks):
            stage["res"].append(_res(gen, c, cout, device))
            c = cout
        if i != len(cfg.dim_mult) - 1:
            ds = {"conv": _conv2d(gen, 3, 3, cout, cout, device)}
            if cfg.temporal_downsample[i]:
                ds["time_conv"] = _conv(gen, 3, 1, 1, cout, cout, device)
            stage["downsample"] = ds
        down.append(stage)
    enc.update(down=down,
               mid_res1=_res(gen, dims[-1], dims[-1], device),
               mid_attn=_attn(gen, dims[-1], device),
               mid_res2=_res(gen, dims[-1], dims[-1], device),
               head_norm=_gamma(dims[-1], device),
               head_conv=_conv(gen, 3, 3, 3, dims[-1], 2 * cfg.z_dim, device))
    return enc


def init_params(cfg: VAEConfig, generator: torch.Generator,
                device=None, encoder: bool = False) -> Params:
    """Random fp32 parameters with the distributions and tree of the JAX
    ``init_params`` (vae.py:321-395; the numbers differ). By default only
    the parts decoding runs are built, ``decoder`` and ``conv2``;
    ``encoder`` adds ``encoder`` and ``conv1``, for a tree that exports as
    a whole reference checkpoint (``vae_convert.vae_state_dict``)."""
    gen = generator
    ddims = [cfg.dim * u for u in
             (cfg.dim_mult[-1],) + tuple(reversed(cfg.dim_mult))]
    temporal_upsample = tuple(reversed(cfg.temporal_downsample))
    dec: Params = {
        "conv1": _conv(gen, 3, 3, 3, cfg.z_dim, ddims[0], device),
        "mid_res1": _res(gen, ddims[0], ddims[0], device),
        "mid_attn": _attn(gen, ddims[0], device),
        "mid_res2": _res(gen, ddims[0], ddims[0], device),
    }
    up = []
    for i, (cin, cout) in enumerate(zip(ddims[:-1], ddims[1:])):
        if i in (1, 2, 3):
            cin = cin // 2  # the previous upsample halved the channels
        stage: Params = {"res": []}
        c = cin
        for _ in range(cfg.num_res_blocks + 1):
            stage["res"].append(_res(gen, c, cout, device))
            c = cout
        if i != len(cfg.dim_mult) - 1:
            us = {"conv": _conv2d(gen, 3, 3, cout, cout // 2, device)}
            if temporal_upsample[i]:
                us["time_conv"] = _conv(gen, 3, 1, 1, cout, cout * 2, device)
            stage["upsample"] = us
        up.append(stage)
    dec.update(up=up, head_norm=_gamma(ddims[-1], device),
               head_conv=_conv(gen, 3, 3, 3, ddims[-1], 3, device))
    params = {"decoder": dec,
              "conv2": _conv(gen, 1, 1, 1, cfg.z_dim, cfg.z_dim, device)}
    if encoder:
        params["encoder"] = _init_encoder(cfg, gen, device)
        params["conv1"] = _conv(gen, 1, 1, 1, 2 * cfg.z_dim, 2 * cfg.z_dim,
                                device)
    return params
