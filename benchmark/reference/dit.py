"""The Wan2.1 text-to-video DiT in plain float32 PyTorch, written from the
published model (``wan/modules/model.py`` of Wan2.1: patch embedding,
sinusoidal time embedding, AdaLN blocks of 3D-RoPE self-attention with
RMS q/k norms, text cross-attention and a GELU-tanh FFN, the modulated
head).

It holds no weights: ``params(group)`` gives a group's leaves in float32
(``weights.py`` names and groups), so that the serving check draws one
block at a time and the training check hands in its own leaves. The
attention is softmax(q kᵀ / √d) v over blocks of queries, one head at a
time, so that the logits of a 32,760-token clip fit. ``remat`` recomputes
each block, and each block of queries of each head, in the backward
(``torch.utils.checkpoint``), so that the training check fits as well.
``fp8`` rounds both operands of every linear through float8 e4m3 with a
per-tensor scale first: the control, this model one precision below the
bf16 it is served in.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Callable[[str], Dict[str, torch.Tensor]]

# Query rows per block of the reference attention: 8,192 rows of fp32
# logits against 32,760 keys are 1.07 GB.
QUERY_BLOCK = 8192


@contextlib.contextmanager
def exact_fp32():
    """fp32 matmuls and convolutions in fp32, not TF32, inside."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through float8 e4m3 with a per-tensor scale that maps
    its largest magnitude to 448, back in x's dtype. The gradient passes
    through unrounded (the rounding of a forward operand, as fp8 training
    scales its gradients apart)."""
    with torch.no_grad():
        scale = x.abs().amax().clamp_min(1e-30) / 448.0
        q = (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach() if x.requires_grad else q


class Model:
    """What every layer needs: the leaves, the model sizes, the control
    switch and the rematerialisation switch."""

    def __init__(self, params: Params, m: dict, fp8: bool = False,
                 remat: bool = False):
        self.params, self.m, self.fp8, self.remat = params, m, fp8, remat

    def linear(self, x, w, b=None):
        if self.fp8:
            x, w = fp8_round(x), fp8_round(w)
        out = x @ w.t()
        return out if b is None else out + b


def layer_norm(x, eps=1e-6):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def sinusoidal(dim: int, t: torch.Tensor) -> torch.Tensor:
    half = dim // 2
    freqs = torch.pow(torch.tensor(10000.0, dtype=torch.float64),
                      -torch.arange(half, dtype=torch.float64) / half)
    ang = t.double()[:, None].cpu() * freqs[None]
    return torch.cat([ang.cos(), ang.sin()], 1).float().to(t.device)


def rope_tables(grid, head_dim: int, device):
    """cos/sin [F·H·W, head_dim/2] for a (F, H, W) grid: the head's complex
    pairs split (t, h, w) as the published ``rope_params`` split them,
    angle p·θ^(−i/n) on each axis, θ = 10,000."""
    c = head_dim // 2
    split = (c - 2 * (c // 3), c // 3, c // 3)
    angs = []
    for n, size, axis in zip(split, grid, range(3)):
        inv = 1.0 / 10000.0 ** (np.arange(n, dtype=np.float64) / n)
        a = np.arange(size, dtype=np.float64)[:, None] * inv[None]
        shape = [1, 1, 1, n]
        shape[axis] = size
        angs.append(np.broadcast_to(a.reshape(shape), (*grid, n)))
    ang = np.concatenate(angs, -1).reshape(-1, c)
    return (torch.tensor(np.cos(ang), dtype=torch.float32, device=device),
            torch.tensor(np.sin(ang), dtype=torch.float32, device=device))


def rope(x, cos, sin):
    """Rotate x [B, L, N, D]'s interleaved pairs (even real, odd
    imaginary)."""
    re, im = x[..., 0::2], x[..., 1::2]
    c, s = cos[None, :, None], sin[None, :, None]
    return torch.stack([re * c - im * s, im * c + re * s], -1).flatten(-2)


def _attend_rows(q, k, v):
    """softmax(q kᵀ / √d) v for one head's block of queries [Lq, D]."""
    logits = (q @ k.t()) * (q.shape[-1] ** -0.5)
    return torch.softmax(logits, -1) @ v


def attention(q, k, v, remat: bool):
    """q [B, Lq, N, D], k/v [B, Lk, N, D] → [B, Lq, N·D]."""
    b, lq, n, d = q.shape
    out = []
    for bi in range(b):
        heads = []
        for h in range(n):
            qh, kh, vh = q[bi, :, h], k[bi, :, h], v[bi, :, h]
            rows = []
            for r0 in range(0, lq, QUERY_BLOCK):
                qb = qh[r0:r0 + QUERY_BLOCK]
                rows.append(checkpoint(_attend_rows, qb, kh, vh,
                                       use_reentrant=False)
                            if remat else _attend_rows(qb, kh, vh))
            heads.append(torch.cat(rows, 0))
        out.append(torch.stack(heads, 1).reshape(lq, n * d))
    return torch.stack(out, 0)


def block(ctx: Model, i: int, x, e0, text, cos, sin):
    m = ctx.m
    P = ctx.params(f"blocks.{i}")
    b = f"blocks.{i}."
    n, d = m["num_heads"], m["dim"]
    dh = d // n
    e = P[b + "modulation"][None] + e0
    e = [e[:, j][:, None] for j in range(6)]

    def lin(name, h):
        return ctx.linear(h, P[b + name + ".weight"], P[b + name + ".bias"])

    def heads(h):
        return h.view(h.shape[0], h.shape[1], n, dh)

    xm = layer_norm(x) * (1 + e[1]) + e[0]
    q, k, v = (lin(f"self_attn.{p}", xm) for p in "qkv")
    if m["qk_norm"]:
        q = rms_norm(q, P[b + "self_attn.norm_q"], m["eps"])
        k = rms_norm(k, P[b + "self_attn.norm_k"], m["eps"])
    y = attention(rope(heads(q), cos, sin), rope(heads(k), cos, sin),
                  heads(v), ctx.remat)
    x = x + lin("self_attn.o", y) * e[2]

    xn = x
    if m["cross_attn_norm"]:
        xn = layer_norm(x) * P[b + "norm3_weight"] + P[b + "norm3_bias"]
    q = lin("cross_attn.q", xn)
    k, v = lin("cross_attn.k", text), lin("cross_attn.v", text)
    if m["qk_norm"]:
        q = rms_norm(q, P[b + "cross_attn.norm_q"], m["eps"])
        k = rms_norm(k, P[b + "cross_attn.norm_k"], m["eps"])
    x = x + lin("cross_attn.o",
                attention(heads(q), heads(k), heads(v), ctx.remat))

    xf = layer_norm(x) * (1 + e[4]) + e[3]
    y = lin("ffn_fc2", F.gelu(lin("ffn_fc1", xf), approximate="tanh"))
    return x + y * e[5]


def patchify(x, patch):
    b, c, f, h, w = x.shape
    pt, ph, pw = patch
    x = x.reshape(b, c, f // pt, pt, h // ph, ph, w // pw, pw)
    x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b, -1, c * pt * ph * pw)


def unpatchify(x, grid, patch, out_dim):
    b = x.shape[0]
    f, h, w = grid
    pt, ph, pw = patch
    x = x.reshape(b, f, h, w, pt, ph, pw, out_dim)
    x = x.permute(0, 7, 1, 4, 2, 5, 3, 6)
    return x.reshape(b, out_dim, f * pt, h * ph, w * pw)


def forward(ctx: Model, x: torch.Tensor, t: torch.Tensor,
            context: torch.Tensor) -> torch.Tensor:
    """x [B, C, F, H, W] latents, t [B] timesteps, context [B, Lt,
    text_dim] → the velocity [B, C_out, F, H, W], all fp32."""
    m = ctx.m
    patch = tuple(m["patch_size"])
    grid = tuple(s // p for s, p in zip(x.shape[2:], patch))
    R = ctx.params("rest")

    def lin(name, h):
        return ctx.linear(h, R[name + ".weight"], R[name + ".bias"])

    xt = lin("patch_embedding", patchify(x, patch))
    e = lin("time_embedding_fc1", sinusoidal(m["freq_dim"], t))
    e = lin("time_embedding_fc2", F.silu(e))
    e0 = lin("time_projection", F.silu(e)).view(-1, 6, m["dim"])
    text = lin("text_embedding_fc2",
               F.gelu(lin("text_embedding_fc1", context), approximate="tanh"))
    cos, sin = rope_tables(grid, m["dim"] // m["num_heads"], x.device)
    for i in range(m["num_layers"]):
        if ctx.remat:
            x_in = xt
            xt = checkpoint(block, ctx, i, x_in, e0, text, cos, sin,
                            use_reentrant=False)
        else:
            xt = block(ctx, i, xt, e0, text, cos, sin)
    hm = R["head_modulation"][None] + e[:, None]
    xh = layer_norm(xt) * (1 + hm[:, 1][:, None]) + hm[:, 0][:, None]
    return unpatchify(lin("head", xh), grid, patch, m["out_dim"])


def drawn_params(seed: int, m: dict, device, cache: Optional[dict] = None,
                 dtype: str = "bfloat16") -> Params:
    """``params(group)`` that draws the DiT's group from the seed as it is
    served (linears in ``dtype``), in fp32. With a ``cache`` the ``rest``
    group is kept there once drawn; blocks are drawn anew each time, one
    in memory at a time."""
    from .weights import dit_init, dit_specs, draw_group, group_specs

    groups = group_specs("dit", dit_specs(m, dtype))
    init = dit_init(m)

    def params(group):
        if cache is not None and group in cache:
            return cache[group]
        leaves = {k: v.float() for k, v in draw_group(
            seed, "dit", group, groups[group], init, device).items()}
        if cache is not None and group == "rest":
            cache[group] = leaves
        return leaves

    return params
