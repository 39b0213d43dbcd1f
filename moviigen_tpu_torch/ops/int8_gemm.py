"""W8A8 linear: int8 × int8 → int32 GEMM with a fused dequant epilogue.

Counterpart of ``moviigen_tpu/ops/int8_gemm.py``:

    out[m, n] = cast(float(Σ_k xq[m, k]·wq[n, k]) · sx[m] · sw[n] (+ bias[n]))

The int32 sum is exact; the epilogue multiplies left to right in fp32,
then adds the bias in one of two orders: in fp32 before the single cast
(the Pallas kernel's and the JAX ``_dense_multi``'s), or, with
``bias_after_cast``, after the cast in the output dtype (the JAX
``_dense``'s: ``cast(v) + cast(bias)``). ``wq`` is ``[N, K]``
(``nn.Linear``'s layout; the JAX leaf is ``[K, N]``) so that both operands
are contiguous along the contraction.

| kernel (``csrc/``) | replaces (Pallas)          | plain version       |
|--------------------|----------------------------|---------------------|
| ``int8_gemm.cu``   | ``int8_gemm.py::_kernel``  | ``int8_gemm_plain`` |

(The activation quantization that feeds it has its own kernel,
``csrc/quantize_act.cu``, in ``ops/quantization.py``.)

A CUDA tensor goes to the kernel, a CPU tensor to the plain version;
there is no fallback between the two. The kernel takes any M ≥ 0, K a
positive multiple of 16 and N a multiple of 8; anything else raises
``ValueError``. The wrapper counts its launches on
``int8_gemm_fused.launches``; ``launch_counts`` also reports the
activation-quantization kernel's (``quantize_activations.launches``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .quantization import quantize_activations

OUT_DTYPES = (torch.bfloat16, torch.float32)
_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# the plain version's fp32 partial sums stay exact: 127² · 1024 < 2²⁴
_PLAIN_K_CHUNK = 1024


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] × int8 [N, K]ᵀ → the exact int32 [M, N]. On the CPU an
    int32 matmul. On the card, where there is none, fp32 matmuls over K
    chunks of 1,024 (each partial sum is an integer below 2²⁴, so exact)
    added up in int32."""
    if not xq.is_cuda:
        return torch.matmul(xq.to(torch.int32), wq.to(torch.int32).t())
    acc = torch.zeros((xq.shape[0], wq.shape[0]), dtype=torch.int32,
                      device=xq.device)
    for k0 in range(0, xq.shape[1], _PLAIN_K_CHUNK):
        k1 = k0 + _PLAIN_K_CHUNK
        acc += torch.matmul(xq[:, k0:k1].float(),
                            wq[:, k0:k1].float().t()).to(torch.int32)
    return acc


def int8_gemm_plain(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
                    sw: torch.Tensor, bias: Optional[torch.Tensor] = None,
                    out_dtype: torch.dtype = torch.bfloat16,
                    bias_after_cast: bool = False) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, on any device."""
    out = int8_matmul(xq, wq).float() * sx.reshape(-1, 1).float() \
        * sw.float()[None, :]
    if bias is None:
        return out.to(out_dtype)
    if bias_after_cast:
        return out.to(out_dtype) + bias.to(out_dtype)[None, :]
    return (out + bias.float()[None, :]).to(out_dtype)


def _check(xq, wq, sx, sw, bias, out_dtype):
    if xq.dim() != 2 or wq.dim() != 2 or xq.shape[1] != wq.shape[1]:
        raise ValueError(f"int8 gemm: xq {tuple(xq.shape)} and wq "
                         f"{tuple(wq.shape)} must be [M, K] and [N, K]")
    m, k = xq.shape
    n = wq.shape[0]
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8 gemm: xq and wq must be int8, got {xq.dtype} "
                        f"and {wq.dtype}")
    if sx.numel() != m or sw.numel() != n:
        raise ValueError(f"int8 gemm: sx has {sx.numel()} entries for M={m}, "
                         f"sw {sw.numel()} for N={n}")
    if bias is not None and bias.numel() != n:
        raise ValueError(f"int8 gemm: bias has {bias.numel()} entries for "
                         f"N={n}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"int8 gemm: out_dtype must be one of {OUT_DTYPES}, "
                        f"got {out_dtype}")
    return m, n, k


def _operand(name: str, x: torch.Tensor, dtype, device) -> torch.Tensor:
    """``x`` as the kernel reads it: on ``device``, ``dtype``, contiguous,
    16-byte aligned."""
    if not x.is_cuda or x.device != device:
        raise ValueError(f"int8 gemm kernel: {name} is not on {device}")
    x = x.to(dtype).contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    return x


def int8_gemm_cuda(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
                   sw: torch.Tensor, bias: Optional[torch.Tensor] = None,
                   out_dtype: torch.dtype = torch.bfloat16,
                   bias_after_cast: bool = False) -> torch.Tensor:
    """Launch the kernel on the current stream. Raises on what it does not
    take; never falls back."""
    m, n, k = _check(xq, wq, sx, sw, bias, out_dtype)
    if k < 16 or k % 16 or n % 8:
        raise ValueError(f"int8 gemm kernel: K={k} must be a positive "
                         f"multiple of 16 and N={n} a multiple of 8")
    dev = xq.device
    xq = _operand("xq", xq, torch.int8, dev)
    wq = _operand("wq", wq, torch.int8, dev)
    sx = _operand("sx", sx.reshape(-1), torch.float32, dev)
    sw = _operand("sw", sw.reshape(-1), torch.float32, dev)
    if bias is not None:
        # after the cast, the kernel adds the bias as output-dtype values
        b = bias.reshape(-1)
        if bias_after_cast:
            b = b.to(out_dtype)
        bias = _operand("bias", b, torch.float32, dev)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    from .. import kernels

    fn = kernels.load("int8_gemm").int8_gemm_dequant
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGS
    err = fn(xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), sw.data_ptr(),
             None if bias is None else bias.data_ptr(), out.data_ptr(),
             m, n, k, int(out_dtype == torch.float32),
             int(bias_after_cast and bias is not None),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8 gemm kernel launch failed: CUDA error {err}")
    kernels.count_launch(int8_gemm_fused)
    return out


def int8_gemm_fused(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
                    sw: torch.Tensor, bias: Optional[torch.Tensor] = None,
                    out_dtype: torch.dtype = torch.bfloat16,
                    bias_after_cast: bool = False) -> torch.Tensor:
    """``(xq·sx) @ (wq·sw)ᵀ + bias`` from int8 inputs.

    xq: [M, K] int8 per-token quantized activations; wq: [N, K] int8
    per-out-channel quantized weights; sx: [M, 1] or [M] fp32; sw: [N]
    fp32; bias: optional [N], any float dtype, added in fp32 before the
    cast, or with ``bias_after_cast`` in ``out_dtype`` after it. Returns
    [M, N] ``out_dtype``. CUDA tensors run the Hopper kernel, CPU tensors
    the plain version."""
    if xq.is_cuda:
        return int8_gemm_cuda(xq, wq, sx, sw, bias, out_dtype,
                              bias_after_cast)
    _check(xq, wq, sx, sw, bias, out_dtype)
    return int8_gemm_plain(xq, wq, sx, sw, bias, out_dtype, bias_after_cast)


int8_gemm_fused.launches = 0


def w8a8_linear(x: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.bfloat16,
                bias_after_cast: bool = False) -> torch.Tensor:
    """W8A8 linear over [..., K] activations: per-token dynamic int8
    activation quantization, then the fused GEMM. q8: [N, K] int8."""
    *lead, k = x.shape
    xq, sx = quantize_activations(x)
    out = int8_gemm_fused(xq.reshape(-1, k), q8, sx.reshape(-1), scale, bias,
                          out_dtype=out_dtype, bias_after_cast=bias_after_cast)
    return out.reshape(*lead, q8.shape[0])


def reset_launch_counts() -> None:
    int8_gemm_fused.launches = 0
    quantize_activations.launches = 0


def launch_counts() -> dict:
    return {"int8_gemm_launches": int8_gemm_fused.launches,
            "quantize_launches": quantize_activations.launches}
