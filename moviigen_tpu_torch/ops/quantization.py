"""Int8 / int4 weight-only and W8A8 quantization of the DiT and umT5
linears.

Counterpart of ``moviigen_tpu/ops/quantization.py``. The arithmetic is the
JAX module's, value for value; the layout is the port's: a weight is
``[out, in]`` as in ``nn.Linear`` where the JAX leaf is ``[in, out]``, so

    int8:  qweight int8  [out, in],      scale fp32 [out]
    int4:  qweight uint8 [out, in // 2], scale fp32 [out, in // g]

- **int8**: per-output-channel absmax / 127 scales.
- **int4**: grouped symmetric over ``g`` = 128 input channels (one group
  when ``in % 128``), q in [-7, 7] stored biased (q + 8), two per byte:
  low nibble = input 2k, high nibble = input 2k + 1.
- **W8A8** (``act8``, int8 only): activations are quantized per token at
  run time (``quantize_activations``: on the card the one-pass kernel
  ``csrc/quantize_act.cu``, plain version ``quantize_activations_plain``)
  and the product is int8 × int8 → int32 (``ops.int8_gemm``); the
  per-channel weight scale and the per-token activation scale factor out
  of the contraction.

Weight-only linears dequantize to the compute dtype per call and go
through ``F.linear``. Embeddings, norms, modulations and the head stay
as they are. ``QuantLinear`` holds one quantized linear as buffers;
``quantize_wan_params`` and ``quantize_t5_params`` swap a model's linears
for it in place. Quantized trees are stored on disk in the JAX layout
(``convert.wan_params_tree`` / ``load_wan_params``) so that either
package reads the other's file.
"""

from __future__ import annotations

import ctypes
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import safetensors as st

# Block linears worth quantizing (the big matmuls), as paths of the JAX
# tree; the port's block holds 'ffn/fc1' as ``ffn_fc1``.
TARGET_SUFFIXES = (
    "self_attn/q", "self_attn/k", "self_attn/v", "self_attn/o",
    "cross_attn/q", "cross_attn/k", "cross_attn/v", "cross_attn/o",
    "cross_attn/k_img", "cross_attn/v_img",
    "ffn/fc1", "ffn/fc2",
)
T5_TARGETS = ("attn/q", "attn/k", "attn/v", "attn/o",
              "ffn/gate", "ffn/fc1", "ffn/fc2")


def quantize_linear(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., out, in] float → (int8 weight, fp32 per-out-channel scale
    [..., out])."""
    w = weight.float()
    scale = w.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.round(w / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale.squeeze(-1)


def quantize_linear_int4(weight: torch.Tensor, group: int = 128
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., out, in] float → (packed uint8 [..., out, in // 2], fp32
    scale [..., out, in // group]); a single group when ``in % group``."""
    w = weight.float()
    *lead, cout, cin = w.shape
    if cin % 2:
        raise ValueError(f"int4 packing needs even input dim, got {cin}")
    g = group if cin % group == 0 else cin
    wg = w.reshape(*lead, cout, cin // g, g)
    scale = wg.abs().amax(dim=-1, keepdim=True) / 7.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.round(wg / scale).clamp_(-7, 7).to(torch.int16)
    biased = (q + 8).to(torch.uint8).reshape(*lead, cout, cin)
    packed = biased[..., 0::2] | (biased[..., 1::2] << 4)
    return packed, scale.squeeze(-1)


def quantize_activations_plain(x: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_activations`` in plain PyTorch, on any device. Both
    divisions are true divisions on every device: divided by a Python
    number, a CUDA tensor is multiplied by its reciprocal instead, which
    is not always the correctly rounded quotient that JAX and the kernel
    compute."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    sx = amax / torch.full_like(amax, 127.0)
    xq = torch.round(xf / sx).clamp_(-127, 127).to(torch.int8)
    return xq, sx


# the kernel's limits (csrc/quantize_act.cu): 8-element vectors, at most
# four of them for each of 1,024 threads
_QUANT_VEC = 8
_QUANT_MAX_K = 4 * 1024 * _QUANT_VEC
_QUANT_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def quantize_activations_cuda(x: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/quantize_act.cu`` on the current stream: bf16 or fp32
    [..., K] with K a multiple of 8 up to 32,768. Raises on anything
    else; never falls back."""
    if not x.is_cuda:
        raise ValueError(f"quantize_act kernel: x is on {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError("quantize_act kernel: x must be bfloat16 or float32, "
                        f"got {x.dtype}")
    k = x.shape[-1] if x.dim() else 0
    if k < _QUANT_VEC or k % _QUANT_VEC or k > _QUANT_MAX_K:
        raise ValueError(f"quantize_act kernel: K={k} must be a positive "
                         f"multiple of {_QUANT_VEC} up to {_QUANT_MAX_K}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    xq = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    sx = torch.empty((*lead, 1), dtype=torch.float32, device=x.device)
    from .. import kernels

    fn = kernels.load("quantize_act").quantize_act
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _QUANT_ARGS
    err = fn(x2.data_ptr(), xq.data_ptr(), sx.data_ptr(), x2.shape[0], k,
             int(x.dtype == torch.float32),
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantize_act kernel launch failed: CUDA error "
                           f"{err}")
    kernels.count_launch(quantize_activations)
    return xq, sx


def quantize_activations(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token dynamic symmetric int8: (xq int8, sx fp32 [..., 1]) with
    x ≈ xq · sx; the absmax runs over the feature (contraction) dim.
    CUDA tensors run the one-pass kernel, CPU tensors the plain version;
    the kernel counts its launches on ``quantize_activations.launches``."""
    if x.is_cuda:
        return quantize_activations_cuda(x)
    return quantize_activations_plain(x)


quantize_activations.launches = 0


def dequantize_leaf(qweight: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """A quantized weight as ``[..., out, in]`` ``dtype``. Codes and scale
    are both cast to ``dtype`` before the multiply (in bf16 that rounds
    the scale), as the JAX ``dequantize_leaf`` does."""
    if qweight.dtype == torch.int8:
        return qweight.to(dtype) * scale.to(dtype)[..., None]
    lo = (qweight & 0xF).to(torch.int8) - 8
    hi = (qweight >> 4).to(torch.int8) - 8
    q = torch.stack([lo, hi], dim=-1)          # [..., out, in // 2, 2]
    *lead, cout, half, _ = q.shape
    ng = scale.shape[-1]
    qg = q.reshape(*lead, cout, ng, 2 * half // ng).to(dtype)
    return (qg * scale.to(dtype)[..., None]).reshape(*lead, cout, 2 * half)


class QuantLinear(nn.Module):
    """One quantized linear: ``qweight``, ``scale`` and ``bias`` as
    buffers (nothing here trains). ``forward`` is the quantized branch of
    the JAX ``_dense``."""

    def __init__(self, in_features: int, out_features: int, bits: int = 8,
                 group: int = 128, act8: bool = False, bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        if bits not in (8, 4):
            raise ValueError(f"bits must be 8 or 4, got {bits}")
        if act8 and bits != 8:
            raise ValueError("act8 (W8A8) requires bits=8")
        if bits == 4 and in_features % 2:
            raise ValueError("int4 packing needs even input dim, got "
                             f"{in_features}")
        self.in_features, self.out_features = in_features, out_features
        self.bits, self.act8, self.group = bits, act8, group
        groups = in_features // group if in_features % group == 0 else 1
        if bits == 8:
            qshape, sshape, qdtype = (out_features, in_features), \
                (out_features,), torch.int8
        else:
            qshape, sshape, qdtype = (out_features, in_features // 2), \
                (out_features, groups), torch.uint8
        self.register_buffer("qweight", torch.empty(qshape, dtype=qdtype,
                                                    device=device))
        self.register_buffer("scale", torch.empty(sshape, dtype=torch.float32,
                                                  device=device))
        self.register_buffer("bias", torch.empty(out_features, dtype=dtype,
                                                 device=device)
                             if bias else None)

    @classmethod
    @torch.no_grad()
    def from_linear(cls, lin: nn.Linear, bits: int = 8, group: int = 128,
                    act8: bool = False) -> "QuantLinear":
        """Quantize ``lin`` (on its device)."""
        out = cls(lin.in_features, lin.out_features, bits, group, act8,
                  bias=lin.bias is not None, dtype=lin.weight.dtype,
                  device="meta")
        if bits == 8:
            out.qweight, out.scale = quantize_linear(lin.weight)
        else:
            out.qweight, out.scale = quantize_linear_int4(lin.weight, group)
        if lin.bias is not None:
            out.bias = lin.bias.detach().clone()
        return out

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> None:
        """Random codes straight on the device, so that a 14B quantized
        model never exists in full precision: int8 codes uniform in
        [-127, 127] with scale 0.02/√in, int4 bytes uniform with scale
        0.34/√in, zero bias (the scales of the JAX
        ``device_init_quantized_wan``; the numbers differ)."""
        q = self.qweight
        lo, hi = (-127, 128) if self.bits == 8 else (0, 256)
        q.copy_(torch.randint(lo, hi, q.shape, generator=generator,
                              dtype=q.dtype, device=q.device))
        self.scale.fill_((0.02 if self.bits == 8 else 0.34)
                         / math.sqrt(self.in_features))
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        cd = dtype or torch.bfloat16
        if self.act8:
            # rescale in fp32, cast, then the bias in the compute dtype:
            # the GEMM's bias-after-cast epilogue
            from .int8_gemm import w8a8_linear

            return w8a8_linear(x, self.qweight, self.scale, self.bias,
                               out_dtype=cd, bias_after_cast=True)
        w = dequantize_leaf(self.qweight, self.scale, cd)
        bias = None if self.bias is None else self.bias.to(cd)
        return F.linear(x.to(cd), w, bias)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features="
                f"{self.out_features}, bits={self.bits}, act8={self.act8}")


class QuantEmbedding(nn.Module):
    """An int8 per-row quantized vocabulary table: ``qweight`` int8
    [V, d], ``scale`` fp32 [V]."""

    def __init__(self, num_embeddings: int, dim: int, device=None):
        super().__init__()
        self.register_buffer("qweight", torch.empty(
            (num_embeddings, dim), dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.empty(
            num_embeddings, dtype=torch.float32, device=device))

    @classmethod
    @torch.no_grad()
    def from_table(cls, table: torch.Tensor) -> "QuantEmbedding":
        out = cls(*table.shape, device="meta")
        out.qweight, out.scale = quantize_linear(table)
        return out

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> None:
        q = self.qweight
        q.copy_(torch.randint(-127, 128, q.shape, generator=generator,
                              dtype=q.dtype, device=q.device))
        self.scale.fill_(1.0 / 127.0)

    def forward(self, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.qweight[ids].to(dtype) \
            * self.scale[ids][..., None].to(dtype)


def _swap_linears(owner_paths, bits, group, act8) -> None:
    for owner, attr in owner_paths:
        lin = getattr(owner, attr, None)
        if isinstance(lin, nn.Linear):
            setattr(owner, attr,
                    QuantLinear.from_linear(lin, bits, group, act8))


def block_linear(block: nn.Module, suffix: str):
    """(owner module, attribute) of the block linear at a JAX tree path
    such as ``'self_attn/q'`` or ``'ffn/fc1'``."""
    head, name = suffix.split("/")
    if head == "ffn":
        return block, f"ffn_{name}"
    return getattr(block, head), name


def quantize_wan_params(model: nn.Module, bits: int = 8, group: int = 128,
                        act8: bool = False) -> nn.Module:
    """Quantize the block linears of a ``WanModel`` in place, one at a
    time on the model's device (each full-precision weight is freed as
    its ``QuantLinear`` takes its place). ``act8`` marks them W8A8."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if act8 and bits != 8:
        raise ValueError("act8 (W8A8) requires bits=8")
    for blk in model.blocks:
        _swap_linears((block_linear(blk, s) for s in TARGET_SUFFIXES),
                      bits, group, act8)
    return model


def quantize_t5_params(model: nn.Module, bits: int = 4, group: int = 128,
                       quantize_embedding: bool = True) -> nn.Module:
    """Weight-only quantize a ``T5Encoder`` in place: the block linears at
    ``bits``, the token embedding int8 per row. Norms and the relative
    position embeddings stay as they are."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    for blk in model.blocks:
        _swap_linears(((blk, t.split("/")[1]) for t in T5_TARGETS),
                      bits, group, False)
    if quantize_embedding and isinstance(model.token_embedding, nn.Parameter):
        table = model.token_embedding
        del model.token_embedding
        model.token_embedding = QuantEmbedding.from_table(table.detach())
    return model


# ------------------------------------------------------------ trees on disk


def save_quantized_checkpoint(path: str, tree: Dict[str, Any],
                              metadata: Optional[Dict[str, str]] = None
                              ) -> None:
    """Write a nested dict of tensors as safetensors with '/'-joined keys;
    ``metadata`` (str → str) goes into the header (the source
    checkpoint's fingerprint, so that a stale cache is found out)."""
    flat: Dict[str, torch.Tensor] = {}

    def walk(t, p=()):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, p + (k,))
        else:
            flat["/".join(p)] = torch.as_tensor(t)

    walk(tree)
    st.save_file(flat, path, metadata=metadata)


def read_quantized_metadata(path: str) -> Dict[str, str]:
    """The header metadata of a quantized cache (empty dict if none)."""
    return st.read_metadata(path)


def load_quantized_checkpoint(path: str, device=None) -> Dict[str, Any]:
    """Inverse of ``save_quantized_checkpoint``: the nested dict of
    tensors."""
    tree: Dict[str, Any] = {}
    for key, value in st.load_file(path, device).items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree
