"""XLM-RoBERTa-CLIP (ViT-H/14), the image conditioning tower of i2v, in
PyTorch.

Counterpart of ``moviigen_tpu/models/clip.py`` (ref ``wan/modules/clip.py``
and ``xlm_roberta.py``). At run time only the vision tower matters:
``visual_features`` returns the 31st block's 257 tokens (CLS + 16 × 16
patches) that the i2v DiT's ``img_emb`` projects (``use_31_block``). The
text tower ships in the checkpoint and is ported for completeness;
nothing calls it.

The tower runs in fp32, as the JAX package runs it (its parameters are
fp32 and its attention computes in the activations' dtype): on the card
the 31 attention calls go through the fp32 flash kernel
(``csrc/flash_fwd_f32.cu``, head_dim 80), the linears through cuBLAS in
fp32 (TF32 off unless the caller turns it on). Its MLP uses the exact
GELU (ViT-H), where the DiT uses GELU-tanh.

The blocks are one ``nn.Module`` each where the JAX package stacks them
for ``lax.scan``; linear weights are ``[out, in]``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from ..ops.norms import layer_norm
from ..ops.resize import resize_bicubic

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
CLIP_CHECKPOINT = "models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth"


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """ViT-H/14 (ref clip_xlm_roberta_vit_h_14, clip.py:471-499)."""

    image_size: int = 224
    patch_size: int = 14
    dim: int = 1280
    mlp_ratio: int = 4
    out_dim: int = 1024
    num_heads: int = 16
    num_layers: int = 32
    pool_type: str = "token"
    pre_norm: bool = True
    post_norm: bool = False
    activation: str = "gelu"
    norm_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclasses.dataclass(frozen=True)
class XLMRobertaConfig:
    """ref xlm_roberta.py:146-170."""

    vocab_size: int = 250002
    max_seq_len: int = 514
    type_size: int = 1
    pad_id: int = 1
    dim: int = 1024
    num_heads: int = 16
    num_layers: int = 24
    post_norm: bool = True
    eps: float = 1e-5


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x)  # exact (erf) GELU, as jax.nn.gelu(approximate=False)


class CLIPBlock(nn.Module):
    """Pre- or post-norm transformer block with a fused qkv projection
    (ref clip.py:111-153, the JAX ``_attn_block``)."""

    def __init__(self, dim: int, mlp_dim: int, num_heads: int, eps: float,
                 activation: str, post_norm: bool, dtype, device):
        super().__init__()
        self.num_heads, self.eps = num_heads, eps
        self.activation, self.post_norm = activation, post_norm
        kw = dict(dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.norm1_weight = nn.Parameter(torch.ones(dim, **f32))
        self.norm1_bias = nn.Parameter(torch.zeros(dim, **f32))
        self.to_qkv = nn.Linear(dim, 3 * dim, **kw)
        self.proj = nn.Linear(dim, dim, **kw)
        self.norm2_weight = nn.Parameter(torch.ones(dim, **f32))
        self.norm2_bias = nn.Parameter(torch.zeros(dim, **f32))
        self.fc1 = nn.Linear(dim, mlp_dim, **kw)
        self.fc2 = nn.Linear(mlp_dim, dim, **kw)

    def attn_part(self, h: torch.Tensor, k_lens, backend: str):
        b, s, c = h.shape
        n = self.num_heads
        qkv = self.to_qkv(h).view(b, s, 3, n, c // n)
        # q, k, v stay views of the fused output; the kernel reads strides
        out = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                        k_lens=k_lens, backend=backend,
                        compute_dtype=h.dtype)
        return self.proj(out.reshape(b, s, c))

    def mlp_part(self, h: torch.Tensor) -> torch.Tensor:
        return self.fc2(_act(self.fc1(h), self.activation))

    def forward(self, x: torch.Tensor, k_lens: Optional[torch.Tensor] = None,
                backend: str = "auto") -> torch.Tensor:
        def norm(h, i):
            return layer_norm(h, getattr(self, f"norm{i}_weight"),
                              getattr(self, f"norm{i}_bias"), eps=self.eps)

        if self.post_norm:
            x = x + norm(self.attn_part(x, k_lens, backend), 1)
            return x + norm(self.mlp_part(x), 2)
        x = x + self.attn_part(norm(x, 1), k_lens, backend)
        return x + self.mlp_part(norm(x, 2))


class CLIPVision(nn.Module):
    """The vision tower (ref VisionTransformer, clip.py:240-301)."""

    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig(),
                 dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        d, p = cfg.dim, cfg.patch_size
        f32 = dict(dtype=torch.float32, device=device)
        # pre_norm → the stride-p Conv2d has no bias (clip.py:252-257)
        self.patch_embedding = nn.Linear(3 * p * p, d, bias=not cfg.pre_norm,
                                         dtype=dtype, device=device)
        self.cls_embedding = nn.Parameter(torch.zeros(1, 1, d, **f32))
        self.pos_embedding = nn.Parameter(
            torch.zeros(1, cfg.num_patches + 1, d, **f32))
        self.pre_norm_weight = self.pre_norm_bias = None
        if cfg.pre_norm:
            self.pre_norm_weight = nn.Parameter(torch.ones(d, **f32))
            self.pre_norm_bias = nn.Parameter(torch.zeros(d, **f32))
        self.blocks = nn.ModuleList(
            CLIPBlock(d, int(d * cfg.mlp_ratio), cfg.num_heads, cfg.norm_eps,
                      cfg.activation, cfg.post_norm, dtype, device)
            for _ in range(cfg.num_layers))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "CLIPVision":
        """Random init with the distributions of the JAX
        ``init_vision_params`` (clip.py:205-248; the numbers differ):
        block linears N(0, 1/dim) with zero bias, patch, CLS and position
        embeddings N(0, 1/dim), unit norms."""
        std = 1.0 / math.sqrt(self.cfg.dim)
        for blk in self.blocks:
            for lin in (blk.to_qkv, blk.proj, blk.fc1, blk.fc2):
                lin.weight.normal_(0.0, std, generator=generator)
                lin.bias.zero_()
        self.patch_embedding.weight.normal_(0.0, std, generator=generator)
        if self.patch_embedding.bias is not None:
            self.patch_embedding.bias.zero_()
        self.cls_embedding.normal_(0.0, std, generator=generator)
        self.pos_embedding.normal_(0.0, std, generator=generator)
        return self

    def forward(self, x: torch.Tensor, use_31_block: bool = True,
                backend: str = "auto") -> torch.Tensor:
        """x: [B, 3, H, W] normalized images → [B, 1 + patches, dim], the
        output of the first num_layers − 1 blocks (``use_31_block``) or of
        all (the JAX ``vision_forward``, clip.py:110-145)."""
        cfg = self.cfg
        b, p, g = x.shape[0], cfg.patch_size, cfg.image_size // cfg.patch_size
        # the stride == kernel conv as a reshape and a matmul
        xh = x.reshape(b, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5)
        xh = self.patch_embedding(xh.reshape(b, g * g, 3 * p * p))
        cls = self.cls_embedding.expand(b, 1, cfg.dim).to(xh.dtype)
        xh = torch.cat([cls, xh], dim=1) + self.pos_embedding.to(xh.dtype)
        if cfg.pre_norm:
            xh = layer_norm(xh, self.pre_norm_weight, self.pre_norm_bias,
                            eps=cfg.norm_eps)
        n_blocks = cfg.num_layers - 1 if use_31_block else cfg.num_layers
        for blk in self.blocks[:n_blocks]:
            xh = blk(xh, backend=backend)
        return xh


class XLMRobertaText(nn.Module):
    """The text tower (ref XLMRoberta, xlm_roberta.py:104-143): token,
    type and position embeddings, post-norm blocks with exact GELU and a
    key mask from the padding."""

    def __init__(self, cfg: XLMRobertaConfig = XLMRobertaConfig(),
                 dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim
        f32 = dict(dtype=torch.float32, device=device)
        self.token_embedding = nn.Parameter(
            torch.zeros(cfg.vocab_size, d, dtype=dtype, device=device))
        self.type_embedding = nn.Parameter(
            torch.zeros(cfg.type_size, d, dtype=dtype, device=device))
        self.pos_embedding = nn.Parameter(
            torch.zeros(cfg.max_seq_len, d, dtype=dtype, device=device))
        self.norm_weight = nn.Parameter(torch.ones(d, **f32))
        self.norm_bias = nn.Parameter(torch.zeros(d, **f32))
        self.blocks = nn.ModuleList(
            CLIPBlock(d, 4 * d, cfg.num_heads, cfg.eps, "gelu",
                      cfg.post_norm, dtype, device)
            for _ in range(cfg.num_layers))

    def forward(self, ids: torch.Tensor,
                backend: str = "auto") -> torch.Tensor:
        """ids: [B, S] (padded with ``pad_id`` at the end) → [B, S, dim]
        (the JAX ``text_forward``, clip.py:148-175)."""
        cfg = self.cfg
        mask = (ids != cfg.pad_id).long()
        pos = cfg.pad_id + torch.cumsum(mask, dim=1) * mask
        x = (self.token_embedding[ids] + self.type_embedding[0][None, None]
             + self.pos_embedding[pos])
        norm = dict(weight=self.norm_weight, bias=self.norm_bias, eps=cfg.eps)
        if cfg.post_norm:
            x = layer_norm(x, **norm)
        k_lens = mask.sum(dim=1)
        for blk in self.blocks:
            x = blk(x, k_lens=k_lens, backend=backend)
        if not cfg.post_norm:
            x = layer_norm(x, **norm)
        return x


# ---------------------------------------------------- frames and features


def preprocess_frames(frames: torch.Tensor, image_size: int = 224
                      ) -> torch.Tensor:
    """[B, 3, H, W] in [-1, 1] → resized to image_size² (antialiased
    bicubic, as ``jax.image.resize``) and CLIP-normalized (ref
    CLIPModel.visual, clip.py:527-540)."""
    x = resize_bicubic(frames, (image_size, image_size))
    x = x * 0.5 + 0.5
    mean = torch.tensor(CLIP_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=x.dtype, device=x.device)
    return (x - mean[None, :, None, None]) / std[None, :, None, None]


@torch.no_grad()
def visual_features(model: CLIPVision, frames: torch.Tensor,
                    backend: str = "auto") -> torch.Tensor:
    """First-frame conditioning features for i2v: [B, 3, H, W] in [-1, 1]
    → [B, 257, 1280] at ViT-H/14 (the JAX ``visual_features``)."""
    x = preprocess_frames(frames, model.cfg.image_size)
    return model(x, use_31_block=True, backend=backend)


# ------------------------------------------------------------ checkpoint

# a block's parameters → their names under ``transformer.{i}.`` in the
# reference checkpoint
BLOCK_KEYS = {"norm1_weight": "norm1.weight", "norm1_bias": "norm1.bias",
              "to_qkv.weight": "attn.to_qkv.weight",
              "to_qkv.bias": "attn.to_qkv.bias",
              "proj.weight": "attn.proj.weight", "proj.bias": "attn.proj.bias",
              "norm2_weight": "norm2.weight", "norm2_bias": "norm2.bias",
              "fc1.weight": "mlp.0.weight", "fc1.bias": "mlp.0.bias",
              "fc2.weight": "mlp.2.weight", "fc2.bias": "mlp.2.bias"}


@torch.no_grad()
def load_clip_state_dict(model: CLIPVision,
                         sd: Mapping[str, torch.Tensor],
                         prefix: str = "visual.") -> CLIPVision:
    """Copy the vision tower of a reference-layout state dict into
    ``model`` (the JAX ``convert_clip_vision_state_dict``, clip.py:251-303):
    keys are read by name under ``prefix``; the rest (``textual.*``, the
    pooling head) is ignored, as in JAX."""
    cfg = model.cfg

    def put(param: torch.Tensor, key: str) -> None:
        value = sd[prefix + key]
        if value.numel() != param.numel():
            raise ValueError(f"CLIP checkpoint key {prefix + key!r}: shape "
                             f"{tuple(value.shape)}, the config needs "
                             f"{tuple(param.shape)}")
        param.copy_(value.reshape(param.shape))

    put(model.patch_embedding.weight, "patch_embedding.weight")  # [D, 3·p·p]
    if model.patch_embedding.bias is not None:
        put(model.patch_embedding.bias, "patch_embedding.bias")
    put(model.cls_embedding, "cls_embedding")
    put(model.pos_embedding, "pos_embedding")
    if cfg.pre_norm:
        put(model.pre_norm_weight, "pre_norm.weight")
        put(model.pre_norm_bias, "pre_norm.bias")
    for i, blk in enumerate(model.blocks):
        params = dict(blk.named_parameters())
        for port, ref in BLOCK_KEYS.items():
            put(params[port], f"transformer.{i}.{ref}")
    return model


def load_clip_checkpoint(path: str,
                         cfg: CLIPVisionConfig = CLIPVisionConfig(),
                         dtype=torch.float32, device=None) -> CLIPVision:
    """The i2v CLIP checkpoint (``.pth``) → the vision tower in ``dtype``
    on ``device`` (the JAX ``load_clip_checkpoint``)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model = CLIPVision(cfg, dtype=dtype, device="meta")
    model = model.to_empty(device=device or "cpu")
    return load_clip_state_dict(model, {k: v.float() for k, v in sd.items()})

