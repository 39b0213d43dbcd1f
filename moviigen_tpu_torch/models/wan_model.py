"""WanModel — the Wan2.1/MoviiGen diffusion transformer, t2v and i2v, in
PyTorch.

Counterpart of ``moviigen_tpu/models/wan_model.py`` (3D patch-embed →
``num_layers`` AdaLN-modulated blocks of 3D-RoPE self-attention, text
cross-attention and a GELU-tanh FFN → 2-way-modulated head → unpatchify),
without the JAX memory streams. The i2v variant (``model_type="i2v"``)
concatenates the conditioning ``y`` to the latents before the patch
embedding, projects the CLIP features through ``img_emb`` (exact GELU) in
front of the text tokens, and gives the cross-attention a second key/value
pair for those 257 image tokens, whose attention output is summed with the
text one before the o-projection. The blocks are one ``nn.Module`` each in
an ``nn.ModuleList`` where the JAX package stacks them for ``lax.scan``.
With ``quant`` (int8 | int4 | w8a8) the block linears are ``QuantLinear``s
(``ops/quantization.py``); embeddings, modulations, norms and the head
stay as they are.

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
from torch.utils.checkpoint import checkpoint

from ..configs import WanModelConfig
from ..ops.attention import attention
from ..ops.int8_gemm import int8_gemm_fused
from ..ops.norms import layer_norm, rms_norm
from ..ops.quantization import QuantLinear, quantize_activations
from ..ops.rope import RopeTables, rope_apply

QUANT_MODES = (None, "int8", "int4", "w8a8")

# Above this many bytes of concatenated bf16 output the JAX ``_dense_multi``
# computes its projections one by one (wan_model.py:226-253). Only the
# W8A8 arithmetic depends on it here: below it the bias is added in fp32
# before the cast, above it in the compute dtype after it.
_FUSE_BYTES_LIMIT = 1 << 30


def _lora_side(lin: nn.Module, x: torch.Tensor,
               out: torch.Tensor) -> torch.Tensor:
    """``out`` plus the rank-r side path of the adapter mounted on ``lin``
    (``training/lora.py::attach_lora``), if any: the JAX ``_lora_side``
    (wan_model.py:160-171), run after every base GEMM that carries one."""
    adapter = lin._modules.get("lora")
    return out if adapter is None else adapter.side(x, out)


def _dense(lin: nn.Module, x: torch.Tensor,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x @ W^T + b with x and the weights cast to ``dtype`` (default: the
    weight dtype) — the JAX ``_dense`` (wan_model.py:174-223). A
    ``QuantLinear`` dequantizes its weight first or, marked W8A8, runs the
    int8 GEMM. A mounted LoRA adapter adds its side path after."""
    if isinstance(lin, QuantLinear):
        return _lora_side(lin, x, lin(x, dtype))
    cd = dtype or lin.weight.dtype
    bias = None if lin.bias is None else lin.bias.to(cd)
    return _lora_side(lin, x, F.linear(x.to(cd), lin.weight.to(cd), bias))


def _dense_multi(lins, x: torch.Tensor,
                 dtype: Optional[torch.dtype] = None):
    """Several projections of the same input — the JAX ``_dense_multi``
    (wan_model.py:234-295). Per output column the arithmetic is
    ``_dense``'s, except for W8A8 linears under the fuse limit: the input
    is quantized once for the group, and each GEMM adds its bias in fp32
    before the cast. The projections stay separate GEMMs sharing the
    quantized input (the JAX package concatenates the weights to widen
    the product; per column that is the same sum). Each output then gets
    its linear's LoRA side path, if one is mounted."""
    tokens = x.numel() // x.shape[-1]
    total_out = sum(lin.out_features for lin in lins)
    if (2 * tokens * total_out > _FUSE_BYTES_LIMIT
            or not all(isinstance(lin, QuantLinear) and lin.act8
                       for lin in lins)):
        return [_dense(lin, x, dtype) for lin in lins]
    cd = dtype or torch.bfloat16
    xq, sx = quantize_activations(x)
    xq, sx = xq.reshape(tokens, -1), sx.reshape(tokens)
    return [_lora_side(lin, x, int8_gemm_fused(
        xq, lin.qweight, sx, lin.scale, lin.bias,
        out_dtype=cd).reshape(*x.shape[:-1], -1)) for lin in lins]


def _block_linear(cin: int, cout: int, dtype, device, quant) -> nn.Module:
    if quant is None:
        return nn.Linear(cin, cout, dtype=dtype, device=device)
    return QuantLinear(cin, cout, bits=4 if quant == "int4" else 8,
                       act8=quant == "w8a8", dtype=dtype, device=device)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """The exact GELU as ``jax.nn.gelu(approximate=False)`` computes it, in
    x's dtype with a rounding after each op: 0.5·x·erfc(−x·√½). In bf16
    that is bit-equal to JAX, where ``F.gelu``, rounding once, differs in
    a third of the values by a step."""
    sqrt_half = torch.tensor(math.sqrt(0.5), dtype=x.dtype, device=x.device)
    return 0.5 * x * torch.special.erfc(-x * sqrt_half)


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


# The i2v context puts this many CLIP image tokens (CLS + 16 × 16 patches)
# before the text tokens (ref model.py:206-207, the JAX _i2v_cross_kv).
IMG_TOKENS = 257
# The CLIP feature width that ``img_emb`` takes (ViT-H/14).
CLIP_DIM = 1280


class Attention(nn.Module):
    """q/k/v/o projections with full-dim RMS qk-norm scales (fp32); with
    ``img`` (the i2v cross-attention) also the image tokens' k_img / v_img
    and their norm_k_img (ref model.py:194-197)."""

    def __init__(self, cfg: WanModelConfig, dtype, device, quant=None,
                 img: bool = False):
        super().__init__()
        d = cfg.dim
        self.img = img
        names = ("q", "k", "v", "o") + (("k_img", "v_img") if img else ())
        for name in names:
            setattr(self, name, _block_linear(d, d, dtype, device, quant))
        self.norm_q = self.norm_k = self.norm_k_img = None
        if cfg.qk_norm:
            self.norm_q = nn.Parameter(
                torch.ones(d, dtype=torch.float32, device=device))
            self.norm_k = nn.Parameter(
                torch.ones(d, dtype=torch.float32, device=device))
            if img:
                self.norm_k_img = nn.Parameter(
                    torch.ones(d, dtype=torch.float32, device=device))


class WanAttentionBlock(nn.Module):
    """One AdaLN block (ref WanAttentionBlock, model.py:229-313)."""

    def __init__(self, cfg: WanModelConfig, dtype, device, quant=None):
        super().__init__()
        d = cfg.dim
        self.cfg = cfg
        self.self_attn = Attention(cfg, dtype, device, quant)
        self.cross_attn = Attention(cfg, dtype, device, quant,
                                    img=cfg.model_type == "i2v")
        self.ffn_fc1 = _block_linear(d, cfg.ffn_dim, dtype, device, quant)
        self.ffn_fc2 = _block_linear(cfg.ffn_dim, d, dtype, device, quant)
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
        q, k, v = _dense_multi([p.q, p.k, p.v], xm, cd)
        if cfg.qk_norm:
            q = rms_norm(q, p.norm_q, eps=cfg.eps)
            k = rms_norm(k, p.norm_k, eps=cfg.eps)
        q = rope_apply(self._heads(q), rope)
        k = rope_apply(self._heads(k), rope)
        out = attention(q, k, self._heads(v), k_lens=k_lens, backend=backend,
                        compute_dtype=cd)
        b, l = out.shape[:2]
        return _dense(p.o, out.reshape(b, l, cfg.dim), cd)

    def _cross_kv(self, pk, pv, norm_k, context, cd):
        k, v = _dense_multi([pk, pv], context, cd)
        if norm_k is not None:
            k = rms_norm(k, norm_k, eps=self.cfg.eps)
        return self._heads(k), self._heads(v)

    def cross_attention(self, xn, context, cd, backend):
        """ref WanT2VCrossAttention (model.py:159-181): no key mask, so the
        zero-padded text tokens are attended to, as in the JAX forward.
        In the i2v block (ref WanI2VCrossAttention, model.py:184-225; the
        JAX ``_i2v_cross_kv`` / ``_i2v_cross_q_body``) the first
        ``IMG_TOKENS`` context tokens are the image's, with their own k/v:
        q is computed once, attends to the text and to the image tokens
        (neither masked), and the two outputs are summed before the
        o-projection."""
        p, cfg = self.cross_attn, self.cfg
        ctx_txt = context[:, IMG_TOKENS:] if p.img else context
        k, v = self._cross_kv(p.k, p.v, p.norm_k, ctx_txt, cd)
        q = _dense(p.q, xn, cd)
        if cfg.qk_norm:
            q = rms_norm(q, p.norm_q, eps=cfg.eps)
        q = self._heads(q)
        out = attention(q, k, v, k_lens=None, backend=backend,
                        compute_dtype=cd)
        if p.img:
            k, v = self._cross_kv(p.k_img, p.v_img, p.norm_k_img,
                                  context[:, :IMG_TOKENS], cd)
            out = out + attention(q, k, v, k_lens=None, backend=backend,
                                  compute_dtype=cd)
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
    """The t2v or i2v DiT (ref WanModel, model.py:372-633).

    Linear weights are ``dtype`` (bf16 for serving); the time embedding,
    time projection, head, modulations and norm scales are fp32, as in
    the JAX ``init_params``. The i2v model adds ``img_emb`` (ref MLPProj:
    LayerNorm(1280) → fc1 → exact GELU → fc2 → LayerNorm(dim), its
    linears ``dtype``, its norms fp32) and the cross-attention's image
    k/v."""

    def __init__(self, cfg: WanModelConfig, dtype=torch.bfloat16,
                 device=None, quant: Optional[str] = None):
        super().__init__()
        if quant not in QUANT_MODES:
            raise ValueError(f"quant must be int8|int4|w8a8, got {quant!r}")
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
            WanAttentionBlock(cfg, dtype, device, quant)
            for _ in range(cfg.num_layers))
        self.head = nn.Linear(d, math.prod(cfg.patch_size) * cfg.out_dim,
                              **f32)
        self.head_modulation = nn.Parameter(torch.empty(2, d, **f32))
        if cfg.model_type == "i2v":
            self.img_emb_norm1_weight = nn.Parameter(
                torch.ones(CLIP_DIM, **f32))
            self.img_emb_norm1_bias = nn.Parameter(torch.zeros(CLIP_DIM, **f32))
            self.img_emb_fc1 = nn.Linear(CLIP_DIM, CLIP_DIM, **kw)
            self.img_emb_fc2 = nn.Linear(CLIP_DIM, d, **kw)
            self.img_emb_norm2_weight = nn.Parameter(torch.ones(d, **f32))
            self.img_emb_norm2_bias = nn.Parameter(torch.zeros(d, **f32))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "WanModel":
        """Random init with the distributions of the JAX ``init_params``
        (wan_model.py:69-152; the numbers differ): xavier-uniform linears
        with zero bias, std-0.02 normal text/time embeddings, randn/√dim
        modulations, a zero head. Quantized block linears get random
        codes (``QuantLinear.init_random``)."""
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
            elif isinstance(mod, QuantLinear):
                mod.init_random(generator)
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
                     compute_dtype=torch.bfloat16, clip_fea=None, y=None):
        """Patch, time and text embeddings (ref model.py:523-558); for i2v
        ``y`` joins the latents on the channel axis before the patch
        embedding and the projected ``clip_fea`` tokens go before the text
        tokens in ``ctx`` (the JAX ``embed_inputs``, wan_model.py:
        1061-1110). Returns (tokens, e fp32, e0 [B, 6, D] fp32, ctx, grid,
        k_lens)."""
        cfg = self.cfg
        if y is not None:
            x = torch.cat([x, y.to(x.dtype)], dim=1)
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
        if clip_fea is not None:
            ci = layer_norm(clip_fea, self.img_emb_norm1_weight,
                            self.img_emb_norm1_bias)
            ci = _gelu_exact(_dense(self.img_emb_fc1, ci, compute_dtype))
            ci = _dense(self.img_emb_fc2, ci, compute_dtype)
            ci = layer_norm(ci, self.img_emb_norm2_weight,
                            self.img_emb_norm2_bias)
            ctx = torch.cat([ci.to(ctx.dtype), ctx], dim=1)
        return xt, e, e0, ctx, grid, k_lens

    def head_output(self, xr: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
        """Modulated output head, all fp32 (ref model.py:316-343)."""
        hm = self.head_modulation.float()[None] + e[:, None, :]
        xh = layer_norm(xr, eps=1e-6, keep_fp32=True) \
            * (1 + hm[:, 1][:, None, :]) + hm[:, 0][:, None, :]
        return _dense(self.head, xh, torch.float32)

    def run_blocks(self, xr, e0, ctx, rope, k_lens, compute_dtype,
                   attn_backend, remat=False, remat_group=1):
        """The block stack over the residual stream (the JAX ``run_blocks``,
        wan_model.py:1113-1170). ``remat`` recomputes each block in the
        backward (``torch.utils.checkpoint``, non-reentrant), so only the
        block inputs are kept; ``remat_group=g`` nests it: every g-th
        residual is kept, and each block inside a group is checkpointed
        again (one more forward of each block in the backward)."""
        args = (e0, ctx, rope, k_lens, compute_dtype, attn_backend)
        blocks = list(self.blocks)
        g = remat_group if remat else 1

        def ckpt(fn, *a):
            # the blocks draw no random numbers: no RNG state to keep
            return checkpoint(fn, *a, use_reentrant=False,
                              preserve_rng_state=False)

        if g > 1:
            if len(blocks) % g:
                raise ValueError(f"remat_group={g} must divide the "
                                 f"{len(blocks)}-layer stack")

            def group(x, i0):
                for blk in blocks[i0:i0 + g]:
                    x = ckpt(blk, x, *args)
                return x

            for i0 in range(0, len(blocks), g):
                xr = ckpt(group, xr, i0)
        else:
            for blk in blocks:
                xr = ckpt(blk, xr, *args) if remat else blk(xr, *args)
        return xr

    def forward(self, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                rope: RopeTables, seq_len: Optional[int] = None,
                compute_dtype: torch.dtype = torch.bfloat16,
                attn_backend: str = "auto",
                residual_dtype: torch.dtype = torch.float32,
                remat: bool = False, remat_group: int = 1,
                clip_fea: Optional[torch.Tensor] = None,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Denoising forward (ref WanModel.forward, model.py:486-579).

        x: [B, C_in, F, H, W] latents; t: [B] timesteps; context:
        [B, text_len, text_dim] zero-padded text embeddings; rope: tables
        for the (F/pt, H/ph, W/pw) grid; seq_len: pad the token sequence
        to this length (padded keys are masked); remat, remat_group: see
        ``run_blocks`` (training); clip_fea [B, 257, 1280] and y
        [B, C_y, F, H, W]: the i2v conditioning (both or neither, i2v
        only). Returns the fp32 prediction [B, C_out, F, H, W]."""
        cfg = self.cfg
        knobs = [k for k in cfg.memory_knobs() if getattr(cfg, k) is not None]
        if knobs:
            raise NotImplementedError(
                f"memory knobs {knobs} are not implemented in the port "
                "(they do not change the maths; one 80 GB card does not "
                "need them at 480p/720p)")
        if (cfg.model_type == "i2v") != (clip_fea is not None) \
                or (clip_fea is None) != (y is None):
            raise ValueError(f"a {cfg.model_type} DiT takes clip_fea and y "
                             + ("both" if cfg.model_type == "i2v"
                                else "neither"))
        xt, e, e0, ctx, grid, k_lens = self.embed_inputs(
            x, t, context, seq_len=seq_len, compute_dtype=compute_dtype,
            clip_fea=clip_fea, y=y)
        xr = self.run_blocks(xt.to(residual_dtype), e0, ctx, rope, k_lens,
                             compute_dtype, attn_backend, remat, remat_group)
        out = self.head_output(xr, e)
        return unpatchify(out, grid, cfg.patch_size, cfg.out_dim)
