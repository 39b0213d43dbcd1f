"""umT5-XXL text encoder in PyTorch.

Counterpart of ``moviigen_tpu/models/t5.py::encode`` (ref
``wan/modules/t5.py`` T5Encoder, ``shared_pos=False``): per-layer
relative position bias from log buckets, attention with no QK scaling
and an fp32 softmax, GEGLU feed-forward with GELU-tanh, T5 RMS norms.
Activations run in the weight dtype (bf16 for serving). The attention is
plain matmul/softmax, as the JAX encoder leaves it to XLA.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs import T5Config
from ..ops.norms import t5_rms_norm


def relative_position_buckets(lq: int, lk: int, num_buckets: int = 32,
                              max_dist: int = 128,
                              bidirectional: bool = True) -> np.ndarray:
    """Log-bucketed relative positions (ref T5RelativeEmbedding,
    t5.py:245-264). Returns [lq, lk] int32 bucket ids."""
    rel_pos = np.arange(lk)[None, :] - np.arange(lq)[:, None]
    if bidirectional:
        nb = num_buckets // 2
        rel_buckets = (rel_pos > 0).astype(np.int64) * nb
        rel_pos = np.abs(rel_pos)
    else:
        nb = num_buckets
        rel_buckets = np.zeros_like(rel_pos)
        rel_pos = -np.minimum(rel_pos, 0)
    max_exact = nb // 2
    with np.errstate(divide="ignore"):
        rel_large = max_exact + (
            np.log(np.maximum(rel_pos, 1) / max_exact)
            / math.log(max_dist / max_exact) * (nb - max_exact)
        ).astype(np.int64)
    rel_large = np.minimum(rel_large, nb - 1)
    rel_buckets = rel_buckets + np.where(rel_pos < max_exact, rel_pos,
                                         rel_large)
    return rel_buckets.astype(np.int32)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, dtype, device):
        super().__init__()
        d, da, df = cfg.dim, cfg.dim_attn, cfg.dim_ffn
        kw = dict(bias=False, dtype=dtype, device=device)
        self.cfg = cfg
        self.norm1 = nn.Parameter(torch.ones(d, dtype=dtype, device=device))
        self.q = nn.Linear(d, da, **kw)
        self.k = nn.Linear(d, da, **kw)
        self.v = nn.Linear(d, da, **kw)
        self.o = nn.Linear(da, d, **kw)
        self.norm2 = nn.Parameter(torch.ones(d, dtype=dtype, device=device))
        self.gate = nn.Linear(d, df, **kw)
        self.fc1 = nn.Linear(d, df, **kw)
        self.fc2 = nn.Linear(df, d, **kw)
        self.pos_embedding = nn.Parameter(torch.empty(
            cfg.num_buckets, cfg.num_heads, dtype=torch.float32,
            device=device))

    def attn(self, x, mask, buckets):
        """T5Attention (ref t5.py:69-120)."""
        b, l, _ = x.shape
        n, dh = self.cfg.num_heads, self.cfg.head_dim
        q = self.q(x).view(b, l, n, dh).transpose(1, 2)
        k = self.k(x).view(b, l, n, dh).transpose(1, 2)
        v = self.v(x).view(b, l, n, dh).transpose(1, 2)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        logits = logits + self.pos_embedding[buckets].permute(2, 0, 1)[None]
        if mask is not None:
            keep = (mask != 0)[:, None, None, :]
            logits = logits.masked_fill(~keep, -3.4e38)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, l, n * dh)
        return self.o(out)

    def forward(self, x, mask, buckets):
        x = x + self.attn(t5_rms_norm(x, self.norm1), mask, buckets)
        h = t5_rms_norm(x, self.norm2)
        gate = F.gelu(self.gate(h), approximate="tanh")
        return x + self.fc2(self.fc1(h) * gate)


class T5Encoder(nn.Module):
    """ids/mask [B, L] → embeddings [B, L, dim] in the weight dtype (ref
    T5Encoder, t5.py:265-312)."""

    def __init__(self, cfg: T5Config, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Parameter(torch.empty(
            cfg.vocab_size, cfg.dim, dtype=dtype, device=device))
        self.blocks = nn.ModuleList(T5Block(cfg, dtype, device)
                                    for _ in range(cfg.num_layers))
        self.norm = nn.Parameter(torch.ones(cfg.dim, dtype=dtype,
                                            device=device))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "T5Encoder":
        """Random init with the distributions of the JAX ``init_params``
        (t5.py:214-248; the numbers differ)."""
        cfg = self.cfg
        d = cfg.dim
        self.token_embedding.normal_(0.0, 1.0, generator=generator)
        for blk in self.blocks:
            for lin, std in ((blk.q, (d * cfg.dim_attn) ** -0.5),
                             (blk.k, d ** -0.5), (blk.v, d ** -0.5),
                             (blk.o, (cfg.num_heads * cfg.head_dim) ** -0.5),
                             (blk.gate, d ** -0.5), (blk.fc1, d ** -0.5),
                             (blk.fc2, cfg.dim_ffn ** -0.5)):
                lin.weight.normal_(0.0, std, generator=generator)
            blk.pos_embedding.normal_(
                0.0, (2 * cfg.num_buckets * cfg.num_heads) ** -0.5,
                generator=generator)
        return self

    def forward(self, ids: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        lq = ids.shape[1]
        buckets = torch.as_tensor(
            relative_position_buckets(lq, lq, self.cfg.num_buckets),
            dtype=torch.long, device=ids.device)
        ids = ids.clamp(0, self.cfg.vocab_size - 1)
        x = self.token_embedding[ids]
        for blk in self.blocks:
            x = blk(x, mask, buckets)
        return t5_rms_norm(x, self.norm)
