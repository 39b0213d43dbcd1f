"""umT5-XXL text encoder (and its decoder) in PyTorch.

Counterpart of ``moviigen_tpu/models/t5.py::encode`` and ``decode`` (ref
``wan/modules/t5.py`` T5Encoder, ``shared_pos=False``): per-layer
relative position bias from log buckets, attention with no QK scaling
and an fp32 softmax, GEGLU feed-forward with GELU-tanh, T5 RMS norms.
Activations run in the weight dtype (bf16 for serving). The attention is
plain matmul/softmax, as the JAX encoder leaves it to XLA. With
``quant_bits`` (8 | 4) the block linears are weight-only ``QuantLinear``s,
dequantized in the activation dtype (the JAX ``_mm``), and the token
embedding is an int8 per-row table (``_embed``).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs import T5Config
from .census import TrackedStateDict
from ..ops.norms import t5_rms_norm
from ..ops.quantization import QuantEmbedding, QuantLinear


def _mm(lin: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``lin(x)``; a quantized linear dequantizes in x's dtype."""
    return lin(x, x.dtype) if isinstance(lin, QuantLinear) else lin(x)


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


def _attend(q, k, v, bias, keep):
    """T5 attention core on [B, N, L, D] heads: fp32 logits with no QK
    scaling, plus ``bias`` (fp32, or None), filled with -3.4e38 where
    ``keep`` (broadcast to the logits, or None) is False, fp32 softmax cast
    to v's dtype before P·V. Returns [B, Lq, N·D]."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if bias is not None:
        logits = logits + bias
    if keep is not None:
        logits = logits.masked_fill(~keep, -3.4e38)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v).transpose(1, 2)
    return out.reshape(out.shape[0], out.shape[1], -1)


def _heads(x, n, dh):
    """[B, L, N·D] → [B, N, L, D]."""
    return x.view(x.shape[0], x.shape[1], n, dh).transpose(1, 2)


def _gated_ffn(blk, h):
    """GEGLU feed-forward: fc2(fc1(h)·gelu_tanh(gate(h))) (ref t5.py:
    123-141)."""
    gate = F.gelu(_mm(blk.gate, h), approximate="tanh")
    return _mm(blk.fc2, _mm(blk.fc1, h) * gate)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, dtype, device, quant_bits=None):
        super().__init__()
        d, da, df = cfg.dim, cfg.dim_attn, cfg.dim_ffn
        self.cfg = cfg

        def linear(cin, cout):
            if quant_bits is None:
                return nn.Linear(cin, cout, bias=False, dtype=dtype,
                                 device=device)
            return QuantLinear(cin, cout, bits=quant_bits, bias=False,
                               dtype=dtype, device=device)

        self.norm1 = nn.Parameter(torch.ones(d, dtype=dtype, device=device))
        self.q = linear(d, da)
        self.k = linear(d, da)
        self.v = linear(d, da)
        self.o = linear(da, d)
        self.norm2 = nn.Parameter(torch.ones(d, dtype=dtype, device=device))
        self.gate = linear(d, df)
        self.fc1 = linear(d, df)
        self.fc2 = linear(df, d)
        self.pos_embedding = nn.Parameter(torch.empty(
            cfg.num_buckets, cfg.num_heads, dtype=torch.float32,
            device=device))

    def attn(self, x, mask, buckets):
        """T5Attention (ref t5.py:69-120)."""
        n, dh = self.cfg.num_heads, self.cfg.head_dim
        keep = None if mask is None else (mask != 0)[:, None, None, :]
        out = _attend(_heads(_mm(self.q, x), n, dh),
                      _heads(_mm(self.k, x), n, dh),
                      _heads(_mm(self.v, x), n, dh),
                      self.pos_embedding[buckets].permute(2, 0, 1)[None],
                      keep)
        return _mm(self.o, out)

    def forward(self, x, mask, buckets):
        x = x + self.attn(t5_rms_norm(x, self.norm1), mask, buckets)
        return x + _gated_ffn(self, t5_rms_norm(x, self.norm2))


class T5Encoder(nn.Module):
    """ids/mask [B, L] → embeddings [B, L, dim] in the weight dtype (ref
    T5Encoder, t5.py:265-312)."""

    def __init__(self, cfg: T5Config, dtype=torch.bfloat16, device=None,
                 quant_bits: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        if quant_bits is None:
            self.token_embedding = nn.Parameter(torch.empty(
                cfg.vocab_size, cfg.dim, dtype=dtype, device=device))
        else:
            self.token_embedding = QuantEmbedding(cfg.vocab_size, cfg.dim,
                                                  device=device)
        self.blocks = nn.ModuleList(
            T5Block(cfg, dtype, device, quant_bits)
            for _ in range(cfg.num_layers))
        self.norm = nn.Parameter(torch.ones(cfg.dim, dtype=dtype,
                                            device=device))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "T5Encoder":
        """Random init with the distributions of the JAX ``init_params``
        (t5.py:214-248; the numbers differ); quantized linears and a
        quantized table get random codes."""
        cfg = self.cfg
        d = cfg.dim
        if isinstance(self.token_embedding, QuantEmbedding):
            self.token_embedding.init_random(generator)
        else:
            self.token_embedding.normal_(0.0, 1.0, generator=generator)
        for blk in self.blocks:
            for lin, std in ((blk.q, (d * cfg.dim_attn) ** -0.5),
                             (blk.k, d ** -0.5), (blk.v, d ** -0.5),
                             (blk.o, (cfg.num_heads * cfg.head_dim) ** -0.5),
                             (blk.gate, d ** -0.5), (blk.fc1, d ** -0.5),
                             (blk.fc2, cfg.dim_ffn ** -0.5)):
                if isinstance(lin, QuantLinear):
                    lin.init_random(generator)
                else:
                    lin.weight.normal_(0.0, std, generator=generator)
            blk.pos_embedding.normal_(
                0.0, (2 * cfg.num_buckets * cfg.num_heads) ** -0.5,
                generator=generator)
        return self

    def forward(self, ids: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                param_gather_fn=None) -> torch.Tensor:
        """``param_gather_fn(module)`` gives the module to run in place of
        the int8 token table and of each block, just before it runs (the
        per-block weight gathers of ``parallel/sharding.py``)."""
        gather = param_gather_fn or (lambda module: module)
        lq = ids.shape[1]
        buckets = torch.as_tensor(
            relative_position_buckets(lq, lq, self.cfg.num_buckets),
            dtype=torch.long, device=ids.device)
        ids = ids.clamp(0, self.cfg.vocab_size - 1)
        if isinstance(self.token_embedding, QuantEmbedding):
            x = gather(self.token_embedding)(ids, self.norm.dtype)
        else:
            x = self.token_embedding[ids]
        for blk in self.blocks:
            x = gather(blk)(x, mask, buckets)
        return t5_rms_norm(x, self.norm)


class T5DecoderBlock(nn.Module):
    """Causal self-attention with a unidirectional position bias, cross-
    attention over the encoder states (no position bias), the GEGLU
    feed-forward, each after a T5 RMS norm (ref T5CrossAttention block,
    t5.py:183-243)."""

    def __init__(self, cfg: T5Config, dtype, device):
        super().__init__()
        d, da, df = cfg.dim, cfg.dim_attn, cfg.dim_ffn
        self.cfg = cfg

        def linear(cin, cout):
            return nn.Linear(cin, cout, bias=False, dtype=dtype,
                             device=device)

        for norm in ("norm1", "norm2", "norm3"):
            setattr(self, norm, nn.Parameter(
                torch.ones(d, dtype=dtype, device=device)))
        for site in ("self_attn", "cross_attn"):
            setattr(self, site, nn.ModuleDict(
                {"q": linear(d, da), "k": linear(d, da), "v": linear(d, da),
                 "o": linear(da, d)}))
        self.gate = linear(d, df)
        self.fc1 = linear(d, df)
        self.fc2 = linear(df, d)
        self.pos_embedding = nn.Parameter(torch.empty(
            cfg.num_buckets, cfg.num_heads, dtype=torch.float32,
            device=device))

    def forward(self, x, keep_self, buckets, enc, keep_cross):
        n, dh = self.cfg.num_heads, self.cfg.head_dim
        sa, ca = self.self_attn, self.cross_attn
        h = t5_rms_norm(x, self.norm1)
        out = _attend(_heads(sa.q(h), n, dh), _heads(sa.k(h), n, dh),
                      _heads(sa.v(h), n, dh),
                      self.pos_embedding[buckets].permute(2, 0, 1)[None],
                      keep_self)
        x = x + sa.o(out)
        h = t5_rms_norm(x, self.norm2)
        out = _attend(_heads(ca.q(h), n, dh), _heads(ca.k(enc), n, dh),
                      _heads(ca.v(enc), n, dh), None, keep_cross)
        x = x + ca.o(out)
        return x + _gated_ffn(self, t5_rms_norm(x, self.norm3))


class T5Decoder(nn.Module):
    """The umT5 decoder (ref T5Decoder, t5.py:315-369; JAX
    ``models/t5.py::decode``): ids [B, S] and the encoder states [B, L,
    dim] → [B, S, dim] in the weight dtype. The reference ships it but never
    runs it; it is here for the umT5 surface. The attention is plain
    matmul/softmax, as in the JAX decoder: its position bias and causal mask
    are outside what the flash kernels compute."""

    def __init__(self, cfg: T5Config, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Parameter(torch.empty(
            cfg.vocab_size, cfg.dim, dtype=dtype, device=device))
        self.blocks = nn.ModuleList(
            T5DecoderBlock(cfg, dtype, device) for _ in range(cfg.num_layers))
        self.norm = nn.Parameter(torch.ones(cfg.dim, dtype=dtype,
                                            device=device))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "T5Decoder":
        """Random init with the encoder's distributions (``T5Encoder.
        init_weights``), both attentions alike."""
        cfg = self.cfg
        d = cfg.dim
        self.token_embedding.normal_(0.0, 1.0, generator=generator)
        for blk in self.blocks:
            lins = [(blk.gate, d ** -0.5), (blk.fc1, d ** -0.5),
                    (blk.fc2, cfg.dim_ffn ** -0.5)]
            for site in (blk.self_attn, blk.cross_attn):
                lins += [(site.q, (d * cfg.dim_attn) ** -0.5),
                         (site.k, d ** -0.5), (site.v, d ** -0.5),
                         (site.o, (cfg.num_heads * cfg.head_dim) ** -0.5)]
            for lin, std in lins:
                lin.weight.normal_(0.0, std, generator=generator)
            blk.pos_embedding.normal_(
                0.0, (2 * cfg.num_buckets * cfg.num_heads) ** -0.5,
                generator=generator)
        return self

    def forward(self, ids: torch.Tensor, encoder_states: torch.Tensor,
                encoder_mask: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``encoder_mask`` [B, L] masks the cross-attention's keys;
        ``mask`` [B, S] the self-attention's, on top of the causal mask
        (JAX ``decode``: the 3D mask is tril(ones) · mask over the keys).
        The encoder states are cast to the weight dtype."""
        s = ids.shape[1]
        dev = ids.device
        buckets = torch.as_tensor(
            relative_position_buckets(s, s, self.cfg.num_buckets,
                                      bidirectional=False),
            dtype=torch.long, device=dev)
        keep_self = torch.ones(s, s, dtype=torch.bool, device=dev).tril()[None]
        if mask is not None:
            keep_self = keep_self & (mask != 0)[:, None, :]
        keep_self = keep_self[:, None]  # [B | 1, 1, S, S]
        keep_cross = (None if encoder_mask is None
                      else (encoder_mask != 0)[:, None, None, :])
        ids = ids.clamp(0, self.cfg.vocab_size - 1)
        x = self.token_embedding[ids]
        enc = encoder_states.to(x.dtype)
        for blk in self.blocks:
            x = blk(x, keep_self, buckets, enc, keep_cross)
        return t5_rms_norm(x, self.norm)


# ------------------------------------------------- reference checkpoints


def t5_key_map(cfg: T5Config):
    """(reference key, port parameter name) for every key of the reference
    ``T5Encoder`` state dict (wan/modules/t5.py:265-310; umT5 has
    ``shared_pos=False``, so every block carries its own relative-position
    embedding). Linear weights are ``[out, in]`` on both sides."""
    pairs = [("token_embedding.weight", "token_embedding"),
             ("norm.weight", "norm")]
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}"
        pairs += [(f"{pre}.norm1.weight", f"{pre}.norm1"),
                  (f"{pre}.norm2.weight", f"{pre}.norm2")]
        pairs += [(f"{pre}.attn.{p}.weight", f"{pre}.{p}.weight")
                  for p in ("q", "k", "v", "o")]
        pairs += [(f"{pre}.ffn.gate.0.weight", f"{pre}.gate.weight"),
                  (f"{pre}.ffn.fc1.weight", f"{pre}.fc1.weight"),
                  (f"{pre}.ffn.fc2.weight", f"{pre}.fc2.weight"),
                  (f"{pre}.pos_embedding.embedding.weight",
                   f"{pre}.pos_embedding")]
    return pairs


def expected_t5_encoder_keys(cfg: T5Config) -> set:
    """The exact checkpoint key set ``load_t5_state_dict`` consumes."""
    return {ref for ref, _ in t5_key_map(cfg)}


@torch.no_grad()
def _load_by_key_map(model: nn.Module, sd, pairs, what: str,
                     strict: bool) -> nn.Module:
    tracked = TrackedStateDict(sd, what)
    params = dict(model.named_parameters())
    for ref, port in pairs:
        value = torch.as_tensor(tracked[ref])
        param = params[port]
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"checkpoint key {ref!r}: shape "
                             f"{tuple(value.shape)}, the config needs "
                             f"{tuple(param.shape)}")
        param.copy_(value)
    if strict:
        tracked.check_all_consumed()
    return model


def _state_dict_by_key_map(model: nn.Module, pairs):
    params = dict(model.named_parameters())
    return {ref: params[port].detach().cpu() for ref, port in pairs}


def load_t5_state_dict(model: T5Encoder, sd, strict: bool = True) -> T5Encoder:
    """Copy a reference-layout encoder state dict into a full-precision
    ``model`` (each tensor cast to its parameter's dtype and device).
    ``strict`` refuses keys that no parameter consumes; a missing key
    always raises."""
    return _load_by_key_map(model, sd, t5_key_map(model.cfg),
                            "T5Encoder checkpoint", strict)


def t5_state_dict(model: T5Encoder):
    """A full-precision ``model``'s parameters under the reference key
    names, on the CPU in the model's dtypes."""
    return _state_dict_by_key_map(model, t5_key_map(model.cfg))


def load_t5_checkpoint(path: str, cfg: T5Config,
                       dtype: torch.dtype = torch.bfloat16, device=None,
                       strict: bool = True) -> T5Encoder:
    """``models_t5_umt5-xxl-enc-bf16.pth`` (a pickled state dict) → a
    ``T5Encoder`` with weights and norms in ``dtype`` (the position
    embeddings stay fp32)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model = T5Encoder(cfg, dtype=dtype, device="meta")
    model = model.to_empty(device=device or "cpu")
    return load_t5_state_dict(model, sd, strict=strict)


def t5_decoder_key_map(cfg: T5Config):
    """(reference key, port parameter name) for every key of the reference
    ``T5Decoder`` state dict (wan/modules/t5.py:315-369)."""
    pairs = [("token_embedding.weight", "token_embedding"),
             ("norm.weight", "norm")]
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}"
        pairs += [(f"{pre}.{nrm}.weight", f"{pre}.{nrm}")
                  for nrm in ("norm1", "norm2", "norm3")]
        pairs += [(f"{pre}.{site}.{p}.weight", f"{pre}.{site}.{p}.weight")
                  for site in ("self_attn", "cross_attn")
                  for p in ("q", "k", "v", "o")]
        pairs += [(f"{pre}.ffn.gate.0.weight", f"{pre}.gate.weight"),
                  (f"{pre}.ffn.fc1.weight", f"{pre}.fc1.weight"),
                  (f"{pre}.ffn.fc2.weight", f"{pre}.fc2.weight"),
                  (f"{pre}.pos_embedding.embedding.weight",
                   f"{pre}.pos_embedding")]
    return pairs


def expected_t5_decoder_keys(cfg: T5Config) -> set:
    """The exact checkpoint key set ``load_t5_decoder_state_dict``
    consumes."""
    return {ref for ref, _ in t5_decoder_key_map(cfg)}


def load_t5_decoder_state_dict(model: T5Decoder, sd,
                               strict: bool = True) -> T5Decoder:
    """Copy a reference-layout decoder state dict into ``model`` (each
    tensor cast to its parameter's dtype and device), under the strict
    census as ``load_t5_state_dict``."""
    return _load_by_key_map(model, sd, t5_decoder_key_map(model.cfg),
                            "T5Decoder checkpoint", strict)


def t5_decoder_state_dict(model: T5Decoder):
    """``model``'s parameters under the reference key names, on the CPU in
    the model's dtypes."""
    return _state_dict_by_key_map(model, t5_decoder_key_map(model.cfg))
