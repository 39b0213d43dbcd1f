"""The umT5 encoder in plain float32 PyTorch, written from the published
model (``wan/modules/t5.py`` of Wan2.1, ``T5Encoder`` with
``shared_pos=False``): a token table, then per block a T5 RMS norm,
attention with no q/k scaling and its own log-bucketed relative position
bias, and a GEGLU feed-forward with GELU-tanh; a final RMS norm.

``relative_buckets`` is the published bucketing (``T5RelativeEmbedding``,
bidirectional, 32 buckets, max distance 128).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .dit import fp8_round


def relative_buckets(length: int, num_buckets: int = 32,
                     max_dist: int = 128) -> np.ndarray:
    rel = np.arange(length)[None, :] - np.arange(length)[:, None]
    nb = num_buckets // 2
    out = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    exact = nb // 2
    with np.errstate(divide="ignore"):
        large = exact + (np.log(np.maximum(rel, 1) / exact)
                         / math.log(max_dist / exact)
                         * (nb - exact)).astype(np.int64)
    return out + np.where(rel < exact, rel, np.minimum(large, nb - 1))


def _rms(x, w, eps=1e-6):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def encode(params, t: dict, ids: torch.Tensor, mask: torch.Tensor,
           fp8: bool = False) -> torch.Tensor:
    """ids, mask [B, L] → [B, L, dim] fp32, zero past each prompt's
    length as the pipeline hands it to the DiT. ``params(group)`` gives
    a group's leaves in fp32. ``fp8`` rounds both operands of every
    linear through float8 e4m3 first (``dit.fp8_round``): the control."""
    n, dh = t["num_heads"], t["dim_attn"] // t["num_heads"]
    b, length = ids.shape
    buckets = torch.as_tensor(relative_buckets(length, t["num_buckets"]),
                              device=ids.device)
    keep = (mask != 0)[:, None, None, :]

    def mm(h, w):
        return (fp8_round(h) @ fp8_round(w).t()) if fp8 else h @ w.t()

    rest = params("rest")
    x = rest["token_embedding"][
        ids.clamp(0, t["vocab_size"] - 1)]
    for i in range(t["num_layers"]):
        P = params(f"blocks.{i}")
        p = f"blocks.{i}."

        def heads(h):
            return h.view(b, length, n, dh).transpose(1, 2)

        h = _rms(x, P[p + "norm1"])
        q, k, v = (heads(mm(h, P[p + f"{s}.weight"])) for s in "qkv")
        logits = q @ k.transpose(-1, -2) \
            + P[p + "pos_embedding"][buckets].permute(2, 0, 1)[None]
        logits = logits.masked_fill(~keep, -3.4e38)
        out = (torch.softmax(logits, -1) @ v).transpose(1, 2)
        x = x + mm(out.reshape(b, length, -1), P[p + "o.weight"])
        h = _rms(x, P[p + "norm2"])
        gate = F.gelu(mm(h, P[p + "gate.weight"]), approximate="tanh")
        x = x + mm(mm(h, P[p + "fc1.weight"]) * gate, P[p + "fc2.weight"])
    x = _rms(x, rest["norm"])
    return x * mask[..., None].to(x.dtype)


def drawn_params(seed: int, t: dict, device, dtype: str = "bfloat16"):
    """``params(group)`` that draws the encoder's group from the seed as it
    is served (in ``dtype``), in fp32."""
    from .weights import draw_group, group_specs, t5_init, t5_specs

    groups = group_specs("t5", t5_specs(t, dtype))
    init = t5_init(t)
    return lambda g: {k: v.float() for k, v in draw_group(
        seed, "t5", g, groups[g], init, device).items()}
