"""3D rotary position embeddings for video DiT tokens.

Counterpart of ``moviigen_tpu/ops/rope.py``: fp32 cos/sin tables for an
(F, H, W) token grid with the reference's (t, h, w) split of the complex
pairs, and a rotation of interleaved channel pairs (even = real, odd =
imaginary). The pairs are rotated directly; positions past the table pass
through unrotated, and the result is fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


def _axis_freqs(dim_pairs: int, theta: float = 10000.0,
                max_pos: int = 1024) -> np.ndarray:
    """outer(arange(max_pos), theta^(-i/dim_pairs)) in float64."""
    inv = 1.0 / np.power(
        theta, np.arange(0, dim_pairs, dtype=np.float64) / dim_pairs)
    return np.outer(np.arange(max_pos, dtype=np.float64), inv)


def rope_pair_split(head_dim: int) -> Tuple[int, int, int]:
    """Complex-pair split (t, h, w) of a head. ref model.py:44."""
    c = head_dim // 2
    return (c - 2 * (c // 3), c // 3, c // 3)


@dataclasses.dataclass(frozen=True)
class RopeTables:
    """Flattened per-token rotation tables: cos/sin [F*H*W, head_dim//2]
    float32."""

    cos: torch.Tensor
    sin: torch.Tensor

    @property
    def seq_len(self) -> int:
        return self.cos.shape[0]


def rope_3d_freqs(grid: Tuple[int, int, int], head_dim: int,
                  theta: float = 10000.0, max_pos: int = 1024,
                  device=None) -> RopeTables:
    """[L, c] cos/sin tables for a (F, H, W) patch grid (ref
    model.py:54-59): per-axis angles broadcast over the other two axes,
    concatenated in (t, h, w) order, flattened."""
    f, h, w = grid
    ct, ch, cw = rope_pair_split(head_dim)
    ang_t = _axis_freqs(ct, theta, max_pos)[:f]
    ang_h = _axis_freqs(ch, theta, max_pos)[:h]
    ang_w = _axis_freqs(cw, theta, max_pos)[:w]
    ang = np.concatenate([
        np.broadcast_to(ang_t[:, None, None, :], (f, h, w, ct)),
        np.broadcast_to(ang_h[None, :, None, :], (f, h, w, ch)),
        np.broadcast_to(ang_w[None, None, :, :], (f, h, w, cw)),
    ], axis=-1).reshape(f * h * w, ct + ch + cw)
    return RopeTables(
        cos=torch.as_tensor(np.cos(ang), dtype=torch.float32, device=device),
        sin=torch.as_tensor(np.sin(ang), dtype=torch.float32, device=device))


def rope_apply(x: torch.Tensor, tables: RopeTables) -> torch.Tensor:
    """Rotate the interleaved channel pairs of x [B, L, N, D] by the
    per-token tables; positions past the table pass through. fp32 out."""
    l = x.shape[1]
    lr = min(l, tables.seq_len)
    xf = x.float()
    cos = tables.cos[:lr].to(x.device)[None, :, None, :]
    sin = tables.sin[:lr].to(x.device)[None, :, None, :]
    re = xf[:, :lr, :, 0::2]
    im = xf[:, :lr, :, 1::2]
    rot = torch.stack([re * cos - im * sin, im * cos + re * sin],
                      dim=-1).flatten(-2)
    if lr < l:
        rot = torch.cat([rot, xf[:, lr:]], dim=1)
    return rot
