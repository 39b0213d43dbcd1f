"""Normalization ops with the reference's mixed-precision discipline.

Counterpart of ``moviigen_tpu/ops/norms.py``: statistics in fp32, the
normalized value cast back to the input dtype before the (optional)
affine parameters, unless ``keep_fp32``.
"""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             eps: float = 1e-5) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps), cast to x.dtype, then * weight in
    x.dtype (ref model.py:83)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    if weight is not None:
        normed = normed * weight.to(x.dtype)
    return normed


def t5_rms_norm(x: torch.Tensor, weight: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """T5-style RMSNorm (ref t5.py:61-66): mean-square in fp32; the
    normalized activation is fp32 and is cast to the weight dtype when
    that is half precision, then scaled."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    normed = x.float() * torch.rsqrt(var + eps)
    if weight.dtype in (torch.float16, torch.bfloat16):
        normed = normed.to(weight.dtype)
    return weight * normed


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-6,
               keep_fp32: bool = False) -> torch.Tensor:
    """LayerNorm computed in fp32; cast back to x.dtype unless
    ``keep_fp32`` (the AdaLN modulation sites continue in fp32)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    if not keep_fp32:
        normed = normed.to(x.dtype)
    if weight is not None:
        normed = normed * weight
    if bias is not None:
        normed = normed + bias
    return normed
