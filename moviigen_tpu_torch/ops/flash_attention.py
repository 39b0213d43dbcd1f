"""Flash-attention forward: the Hopper CUDA kernel and its plain twin.

Counterpart of ``moviigen_tpu/ops/flash_attention.py`` (``flash_attention``
→ ``_flash_fwd`` → the Pallas ``_flash_kernel``). Non-causal attention
over ``[B, L, N, D]`` tensors with a base-2 online softmax:

- q is pre-scaled by ``scale·log2(e)`` in q's own dtype;
- s = q·kᵀ in fp32; keys at or past the per-batch ``k_lens`` get -1e30;
- P is cast to v's dtype before the P·V product; the accumulator is fp32;
- a row whose normalizer is 0 is divided by 1; the output is q's dtype.

A CUDA tensor goes to the kernel (``csrc/flash_fwd.cu``), a CPU tensor to
``flash_attention_plain``. There is no fallback between the two: what the
kernel does not take raises.

A batch entry whose ``k_lens`` is 0 attends to nothing and gives zeros
here, in both versions (the Pallas kernel averages v over its padded key
blocks there instead); every caller passes at least one key.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

LOG2E = 1.4426950408889634
_NEG_INF = -1e30
KERNEL_HEAD_DIMS = (128,)


def _qscale(scale: float, dtype: torch.dtype) -> torch.Tensor:
    """``scale·log2(e)`` rounded to ``dtype``, as ``_flash_fwd`` folds it
    into q (flash_attention.py:191)."""
    return torch.tensor(scale * LOG2E, dtype=dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          k_lens: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None,
                          block_k: int = 512) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: the same prescale, base-2
    online softmax over key blocks of ``block_k`` and P cast, so memory
    stays O(B·N·Lq·block_k). q: [B, Lq, N, D]; k/v: [B, Lk, N, D]."""
    b, lq, n, d = q.shape
    lk = k.shape[1]
    if scale is None:
        scale = d ** -0.5
    qs = (q * _qscale(scale, q.dtype).to(q.device)).permute(0, 2, 1, 3).float()
    m = torch.full((b, n, lq, 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, n, lq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, n, lq, d), dtype=torch.float32, device=q.device)
    if k_lens is not None:
        klen = k_lens.to(device=q.device, dtype=torch.int64).view(b, 1, 1, 1)
    for j0 in range(0, lk, block_k):
        kb = k[:, j0:j0 + block_k].permute(0, 2, 1, 3).float()
        vb = v[:, j0:j0 + block_k].permute(0, 2, 1, 3)
        s = torch.matmul(qs, kb.transpose(-1, -2))  # [B, N, Lq, bk]
        valid = None
        if k_lens is not None:
            key = torch.arange(j0, j0 + kb.shape[2], device=q.device)
            valid = key.view(1, 1, 1, -1) < klen
            s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp2(s - m_next)
        if valid is not None:
            p = torch.where(valid, p, torch.zeros_like(p))
        alpha = torch.exp2(m - m_next)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(v.dtype).float(), vb.float())
        m = m_next
    l = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / l).to(q.dtype).permute(0, 2, 1, 3)


def _check_kernel_operand(name: str, x: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"flash kernel: {name} must be bfloat16, got {x.dtype}")
    if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:-1]):
        raise ValueError(
            f"flash kernel: {name} needs unit stride on D and strides that "
            f"are multiples of 8 elements, got {tuple(x.stride())}")
    if x.data_ptr() % 16:
        raise ValueError(f"flash kernel: {name} is not 16-byte aligned")


def _kernel_lib():
    from .. import kernels

    lib = kernels.load("flash_fwd")
    fn = lib.flash_fwd_bf16
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_void_p])
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         k_lens: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Launch the Hopper kernel on the current stream. Raises on what it
    does not take; never falls back."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash kernel: q, k, v must be [B, L, N, D]")
    b, lq, n, d = q.shape
    lk = k.shape[1]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel: head dim D={d} is not supported "
                         f"(supported: {KERNEL_HEAD_DIMS})")
    if k.shape != (b, lk, n, d) or v.shape != k.shape:
        raise ValueError(f"flash kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"flash kernel: {name} is not on {q.device}")
        _check_kernel_operand(name, x)
    if scale is None:
        scale = d ** -0.5
    klens_ptr = None
    if k_lens is not None:
        if k_lens.shape != (b,):
            raise ValueError(f"flash kernel: k_lens must be [{b}], got "
                             f"{tuple(k_lens.shape)}")
        k_lens = k_lens.to(device=q.device, dtype=torch.int32).contiguous()
        klens_ptr = k_lens.data_ptr()
    out = torch.empty((b, lq, n, d), dtype=q.dtype, device=q.device)
    fn = _kernel_lib()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             klens_ptr, b, n, lq, lk, d,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *out.stride()[:3],
             float(_qscale(scale, q.dtype)),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    k_lens: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Fused non-causal attention over [B, L, N, D]. CUDA tensors run the
    Hopper kernel (``flash_attention.launches`` counts its launches); CPU
    tensors run ``flash_attention_plain``."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, k_lens, scale)
    return flash_attention_plain(q, k, v, k_lens, scale)


flash_attention.launches = 0
