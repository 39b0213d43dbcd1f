"""WanModel — the Wan2.1/MoviiGen diffusion transformer, t2v, in PyTorch.

Counterpart of ``moviigen_tpu/models/wan_model.py`` (3D patch-embed →
``num_layers`` AdaLN-modulated blocks of 3D-RoPE self-attention, text
cross-attention and a GELU-tanh FFN → 2-way-modulated head → unpatchify),
without quantization and without the JAX memory streams. The blocks are
one ``nn.Module`` each in an ``nn.ModuleList`` where the JAX package
stacks them for ``lax.scan``.

Precision follows the JAX forward: matmul inputs and weights are cast to
``compute_dtype``; time embedding, AdaLN modulation, norm statistics,
the residual adds and the head are fp32 islands; the residual stream is
kept in ``residual_dtype``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import WanModelConfig
from ..ops.attention import attention
from ..ops.norms import layer_norm, rms_norm
from ..ops.rope import RopeTables, rope_apply


def _dense(lin: nn.Linear, x: torch.Tensor,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x @ W^T + b with x and the weights cast to ``dtype`` (default: the
    weight dtype) — the JAX ``_dense`` (wan_model.py:174-223)."""
    cd = dtype or lin.weight.dtype
    bias = None if lin.bias is None else lin.bias.to(cd)
    return F.linear(x.to(cd), lin.weight.to(cd), bias)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def sinusoidal_embedding_1d(dim: int, position: torch.Tensor) -> torch.Tensor:
    """[cos | sin] sinusoidal embedding in fp32 (ref model.py:15-25)."""
    half = dim // 2
    pos = position.float()
    freqs = torch.pow(
        torch.tensor(10000.0, dtype=torch.float32, device=pos.device),
        -torch.arange(half, dtype=torch.float32, device=pos.device) / half)
    sinusoid = pos[:, None] * freqs[None, :]
    return torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=1)


def patchify(x: torch.Tensor, patch_size) -> torch.Tensor:
    """[B, C, F, H, W] → [B, L, C·pt·ph·pw] (the stride==kernel Conv3d of
    the reference as a reshape; channel order [C, pt, ph, pw])."""
    b, c, f, h, w = x.shape
    pt, ph, pw = patch_size
    x = x.reshape(b, c, f // pt, pt, h // ph, ph, w // pw, pw)
    x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b, (f // pt) * (h // ph) * (w // pw), c * pt * ph * pw)


def unpatchify(x: torch.Tensor, grid, patch_size, out_dim: int) -> torch.Tensor:
    """[B, L, pt·ph·pw·c] → [B, c, F, H, W] (ref model.py:581-609)."""
    b = x.shape[0]
    f, h, w = grid
    pt, ph, pw = patch_size
    x = x[:, : f * h * w].reshape(b, f, h, w, pt, ph, pw, out_dim)
    x = torch.einsum("bfhwpqrc->bcfphqwr", x)
    return x.reshape(b, out_dim, f * pt, h * ph, w * pw)


class Attention(nn.Module):
    """q/k/v/o projections with full-dim RMS qk-norm scales (fp32)."""

    def __init__(self, cfg: WanModelConfig, dtype, device):
        super().__init__()
        d = cfg.dim
        kw = dict(dtype=dtype, device=device)
        self.q = nn.Linear(d, d, **kw)
        self.k = nn.Linear(d, d, **kw)
        self.v = nn.Linear(d, d, **kw)
        self.o = nn.Linear(d, d, **kw)
        self.norm_q = self.norm_k = None
        if cfg.qk_norm:
            self.norm_q = nn.Parameter(
                torch.ones(d, dtype=torch.float32, device=device))
            self.norm_k = nn.Parameter(
                torch.ones(d, dtype=torch.float32, device=device))


class WanAttentionBlock(nn.Module):
    """One AdaLN block (ref WanAttentionBlock, model.py:229-313)."""

    def __init__(self, cfg: WanModelConfig, dtype, device):
        super().__init__()
        d = cfg.dim
        self.cfg = cfg
        self.self_attn = Attention(cfg, dtype, device)
        self.cross_attn = Attention(cfg, dtype, device)
        self.ffn_fc1 = nn.Linear(d, cfg.ffn_dim, dtype=dtype, device=device)
        self.ffn_fc2 = nn.Linear(cfg.ffn_dim, d, dtype=dtype, device=device)
        self.modulation = nn.Parameter(
            torch.empty(6, d, dtype=torch.float32, device=device))
        self.norm3_weight = self.norm3_bias = None
        if cfg.cross_attn_norm:
            self.norm3_weight = nn.Parameter(
                torch.ones(d, dtype=torch.float32, device=device))
            self.norm3_bias = nn.Parameter(
                torch.zeros(d, dtype=torch.float32, device=device))

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        b, l, d = x.shape
        return x.view(b, l, self.cfg.num_heads, d // self.cfg.num_heads)

    def self_attention(self, xm, rope, k_lens, cd, backend):
        """ref WanSelfAttention (model.py:102-156)."""
        p, cfg = self.self_attn, self.cfg
        q, k, v = _dense(p.q, xm, cd), _dense(p.k, xm, cd), _dense(p.v, xm, cd)
        if cfg.qk_norm:
            q = rms_norm(q, p.norm_q, eps=cfg.eps)
            k = rms_norm(k, p.norm_k, eps=cfg.eps)
        q = rope_apply(self._heads(q), rope)
        k = rope_apply(self._heads(k), rope)
        out = attention(q, k, self._heads(v), k_lens=k_lens, backend=backend,
                        compute_dtype=cd)
        b, l = out.shape[:2]
        return _dense(p.o, out.reshape(b, l, cfg.dim), cd)

    def cross_attention(self, xn, context, cd, backend):
        """ref WanT2VCrossAttention (model.py:159-181): no key mask, so the
        zero-padded text tokens are attended to, as in the JAX forward."""
        p, cfg = self.cross_attn, self.cfg
        k, v = _dense(p.k, context, cd), _dense(p.v, context, cd)
        q = _dense(p.q, xn, cd)
        if cfg.qk_norm:
            k = rms_norm(k, p.norm_k, eps=cfg.eps)
            q = rms_norm(q, p.norm_q, eps=cfg.eps)
        out = attention(self._heads(q), self._heads(k), self._heads(v),
                        k_lens=None, backend=backend, compute_dtype=cd)
        b, l = out.shape[:2]
        return _dense(p.o, out.reshape(b, l, cfg.dim), cd)

    def forward(self, x, e0, context, rope, k_lens, cd, backend):
        """``x`` is the residual stream; the adds run in fp32 and write
        back ``x.dtype`` (wan_model.py:871-980)."""
        cfg = self.cfg
        rdt = x.dtype
        e = self.modulation.float()[None] + e0          # [B, 6, D] fp32
        e = [e[:, i][:, None, :] for i in range(6)]

        xm = (layer_norm(x, eps=1e-6, keep_fp32=True) * (1 + e[1])
              + e[0]).to(cd)
        y = self.self_attention(xm, rope, k_lens, cd, backend)
        x = (x.float() + y.float() * e[2]).to(rdt)

        if cfg.cross_attn_norm:
            xn = layer_norm(x, self.norm3_weight, self.norm3_bias, eps=1e-6,
                            keep_fp32=True)
        else:
            xn = x
        y = self.cross_attention(xn.to(cd), context, cd,
                                 cfg.cross_attn_backend or backend)
        x = (x.float() + y.float()).to(rdt)

        xf = (layer_norm(x, eps=1e-6, keep_fp32=True) * (1 + e[4])
              + e[3]).to(cd)
        y = _dense(self.ffn_fc2, _gelu_tanh(_dense(self.ffn_fc1, xf, cd)), cd)
        return (x.float() + y.float() * e[5]).to(rdt)


class WanModel(nn.Module):
    """The t2v DiT (ref WanModel, model.py:372-633).

    Linear weights are ``dtype`` (bf16 for serving); the time embedding,
    time projection, head, modulations and norm scales are fp32, as in
    the JAX ``init_params``."""

    def __init__(self, cfg: WanModelConfig, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        if cfg.model_type != "t2v":
            raise NotImplementedError(
                "the port's DiT covers t2v; i2v comes with a later slice")
        self.cfg = cfg
        d = cfg.dim
        f32 = dict(dtype=torch.float32, device=device)
        kw = dict(dtype=dtype, device=device)
        patch_in = cfg.in_dim * math.prod(cfg.patch_size)
        self.patch_embedding = nn.Linear(patch_in, d, **kw)
        self.text_embedding_fc1 = nn.Linear(cfg.text_dim, d, **kw)
        self.text_embedding_fc2 = nn.Linear(d, d, **kw)
        self.time_embedding_fc1 = nn.Linear(cfg.freq_dim, d, **f32)
        self.time_embedding_fc2 = nn.Linear(d, d, **f32)
        self.time_projection = nn.Linear(d, 6 * d, **f32)
        self.blocks = nn.ModuleList(
            WanAttentionBlock(cfg, dtype, device)
            for _ in range(cfg.num_layers))
        self.head = nn.Linear(d, math.prod(cfg.patch_size) * cfg.out_dim,
                              **f32)
        self.head_modulation = nn.Parameter(torch.empty(2, d, **f32))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "WanModel":
        """Random init with the distributions of the JAX ``init_params``
        (wan_model.py:69-152; the numbers differ): xavier-uniform linears
        with zero bias, std-0.02 normal text/time embeddings, randn/√dim
        modulations, a zero head."""
        d = self.cfg.dim

        def xavier(lin):
            bound = math.sqrt(6.0 / (lin.in_features + lin.out_features))
            lin.weight.uniform_(-bound, bound, generator=generator)
            lin.bias.zero_()

        def normal(lin, std=0.02):
            lin.weight.normal_(0.0, std, generator=generator)
            lin.bias.zero_()

        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                xavier(mod)
        for lin in (self.text_embedding_fc1, self.text_embedding_fc2,
                    self.time_embedding_fc1, self.time_embedding_fc2):
            normal(lin)
        for blk in self.blocks:
            blk.modulation.normal_(0.0, 1.0, generator=generator)
            blk.modulation.div_(math.sqrt(d))
        self.head.weight.zero_()
        self.head.bias.zero_()
        self.head_modulation.normal_(0.0, 1.0, generator=generator)
        self.head_modulation.div_(math.sqrt(d))
        return self

    def embed_inputs(self, x, t, context, seq_len=None,
                     compute_dtype=torch.bfloat16):
        """Patch, time and text embeddings (ref model.py:523-558).
        Returns (tokens, e fp32, e0 [B, 6, D] fp32, ctx, grid, k_lens)."""
        cfg = self.cfg
        b = x.shape[0]
        pt, ph, pw = cfg.patch_size
        grid = (x.shape[2] // pt, x.shape[3] // ph, x.shape[4] // pw)
        tokens = grid[0] * grid[1] * grid[2]
        xt = _dense(self.patch_embedding, patchify(x, cfg.patch_size),
                    compute_dtype)
        k_lens = None
        if seq_len is not None and seq_len > tokens:
            xt = F.pad(xt, (0, 0, 0, seq_len - tokens))
            k_lens = torch.full((b,), tokens, dtype=torch.int32,
                                device=x.device)
        emb = sinusoidal_embedding_1d(cfg.freq_dim, t)
        e = _dense(self.time_embedding_fc1, emb, torch.float32)
        e = _dense(self.time_embedding_fc2, F.silu(e), torch.float32)
        e0 = _dense(self.time_projection, F.silu(e), torch.float32)
        e0 = e0.reshape(b, 6, cfg.dim)
        ctx = _dense(self.text_embedding_fc1, context, compute_dtype)
        ctx = _dense(self.text_embedding_fc2, _gelu_tanh(ctx), compute_dtype)
        return xt, e, e0, ctx, grid, k_lens

    def head_output(self, xr: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
        """Modulated output head, all fp32 (ref model.py:316-343)."""
        hm = self.head_modulation.float()[None] + e[:, None, :]
        xh = layer_norm(xr, eps=1e-6, keep_fp32=True) \
            * (1 + hm[:, 1][:, None, :]) + hm[:, 0][:, None, :]
        return _dense(self.head, xh, torch.float32)

    def forward(self, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                rope: RopeTables, seq_len: Optional[int] = None,
                compute_dtype: torch.dtype = torch.bfloat16,
                attn_backend: str = "auto",
                residual_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Denoising forward (ref WanModel.forward, model.py:486-579).

        x: [B, C_in, F, H, W] latents; t: [B] timesteps; context:
        [B, text_len, text_dim] zero-padded text embeddings; rope: tables
        for the (F/pt, H/ph, W/pw) grid; seq_len: pad the token sequence
        to this length (padded keys are masked). Returns the fp32
        prediction [B, C_out, F, H, W]."""
        cfg = self.cfg
        knobs = [k for k in cfg.memory_knobs() if getattr(cfg, k) is not None]
        if knobs:
            raise NotImplementedError(
                f"memory knobs {knobs} are not implemented in the port "
                "(they do not change the maths; one 80 GB card does not "
                "need them at 480p/720p)")
        xt, e, e0, ctx, grid, k_lens = self.embed_inputs(
            x, t, context, seq_len=seq_len, compute_dtype=compute_dtype)
        xr = xt.to(residual_dtype)
        for blk in self.blocks:
            xr = blk(xr, e0, ctx, rope, k_lens, compute_dtype, attn_backend)
        out = self.head_output(xr, e)
        return unpatchify(out, grid, cfg.patch_size, cfg.out_dim)

