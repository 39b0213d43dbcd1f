"""Flash attention, forward and backward: the Hopper CUDA kernels and
their plain twins.

Counterpart of ``moviigen_tpu/ops/flash_attention.py``: ``flash_attention``
(the ``_flash`` custom VJP), ``_flash_fwd`` with and without stats,
``_flash_bwd`` and ``flash_attention_with_stats``. Non-causal attention
over ``[B, L, N, D]`` tensors with a base-2 online softmax:

- q is pre-scaled by ``scale·log2(e)`` in q's own dtype;
- s = q·kᵀ in fp32; keys at or past the per-batch ``k_lens`` get -1e30;
- P is cast to v's dtype before the P·V product; the accumulator is fp32;
- a row whose normalizer is 0 is divided by 1; the output is q's dtype.

The softmax stats m (the row max, base 2) and l (the normalizer) are
``[B, N, Lq]`` fp32 inside this module; ``flash_attention_with_stats``
gives them in the JAX layout ``[B, Lq, N]``, m in natural-log units.

Each kernel has a plain twin here with the same arithmetic:

| kernel (``csrc/``)                 | replaces (Pallas)        | plain twin                     |
|------------------------------------|--------------------------|--------------------------------|
| ``flash_fwd.cu`` forward           | ``_flash_kernel``        | ``flash_attention_plain``      |
| ``flash_fwd.cu`` stats variant     | ``_flash_kernel_stats``  | ``flash_attention_stats_plain``|
| ``flash_bwd.cu`` dKV               | ``_flash_bwd_dkv_kernel``| ``flash_bwd_plain``            |
| ``flash_bwd.cu`` dQ                | ``_flash_bwd_dq_kernel`` | ``flash_bwd_plain``            |
| ``flash_fwd_f32.cu`` fp32 forward  | ``_flash_kernel`` (fp32) | ``flash_attention_plain``      |

A CUDA tensor goes to the kernels, a CPU tensor to the twins. There is no
fallback between the two: what a kernel does not take raises. Under
autograd (grad enabled and an input that requires it) ``flash_attention``
goes through ``FlashAttention``, the counterpart of the ``_flash`` custom
VJP: the stats forward, then the two backward kernels; otherwise it runs
the forward-only kernel: ``flash_fwd.cu`` for bf16 with D = 128,
``flash_fwd_f32.cu`` for fp32 with D a multiple of 8 up to 128 (the CLIP
tower of i2v, D = 80, which neither package differentiates: fp32 CUDA
tensors under autograd raise). Each wrapper counts its launches on
``flash_attention`` (``launches``, ``stats_launches``, ``dkv_launches``,
``dq_launches``, ``f32_launches``).

All four are built for Hopper: every product is a ``wgmma`` on
128-byte-swizzled shared tiles that a producer warp fills by TMA through an
mbarrier ring (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``). The forward
runs one persistent block per SM over 128-row work items, its two consumer
warpgroups taking turns so that one's softmax runs under the other's
products, and prescales q in shared memory. Where there are few keys (the
512-token cross-attention), ``dkv_query_splits`` cuts the dKV query loop
into chunks whose fp32 partial sums a second kernel adds in a fixed order.
q, k, v and dO are read in place through tensor maps made from their
strides.

A batch entry whose ``k_lens`` is 0 attends to nothing and gives zeros
here, in both versions (the Pallas kernel averages v over its padded key
blocks there instead); every caller passes at least one key.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

LOG2E = 1.4426950408889634
_NEG_INF = -1e30
KERNEL_HEAD_DIMS = (128,)
# the fp32 forward (csrc/flash_fwd_f32.cu) takes D a multiple of 8 up to this
F32_MAX_HEAD_DIM = 128
COUNTERS = ("launches", "stats_launches", "dkv_launches", "dq_launches",
            "f32_launches")


def _qscale(scale: float, dtype: torch.dtype) -> torch.Tensor:
    """``scale·log2(e)`` rounded to ``dtype``, as ``_flash_fwd`` folds it
    into q (flash_attention.py:191)."""
    return torch.tensor(scale * LOG2E, dtype=dtype)


def _prescale(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q' = q·bf16(scale·log2 e) in q's dtype, as [B, N, Lq, D] fp32."""
    return (q * _qscale(scale, q.dtype).to(q.device)).permute(0, 2, 1, 3) \
        .float()


def _key_valid(k_lens: Optional[torch.Tensor], b: int, j0: int, nk: int,
               device) -> Optional[torch.Tensor]:
    """[B, 1, 1, nk] mask of keys j0 .. j0 + nk below ``k_lens``."""
    if k_lens is None:
        return None
    klen = k_lens.to(device=device, dtype=torch.int64).view(b, 1, 1, 1)
    return torch.arange(j0, j0 + nk, device=device).view(1, 1, 1, -1) < klen


def flash_attention_stats_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor,
                                k_lens: Optional[torch.Tensor] = None,
                                scale: Optional[float] = None,
                                block_k: int = 512):
    """The kernels' forward arithmetic in plain PyTorch: the same prescale,
    base-2 online softmax over key blocks of ``block_k`` and P cast, so
    memory stays O(B·N·Lq·block_k). q: [B, Lq, N, D]; k/v: [B, Lk, N, D].
    Returns (out [B, Lq, N, D], m [B, N, Lq], l [B, N, Lq]), m base 2."""
    b, lq, n, d = q.shape
    lk = k.shape[1]
    if scale is None:
        scale = d ** -0.5
    qs = _prescale(q, scale)
    m = torch.full((b, n, lq, 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, n, lq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, n, lq, d), dtype=torch.float32, device=q.device)
    for j0 in range(0, lk, block_k):
        kb = k[:, j0:j0 + block_k].permute(0, 2, 1, 3).float()
        vb = v[:, j0:j0 + block_k].permute(0, 2, 1, 3)
        s = torch.matmul(qs, kb.transpose(-1, -2))  # [B, N, Lq, bk]
        valid = _key_valid(k_lens, b, j0, kb.shape[2], q.device)
        if valid is not None:
            s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp2(s - m_next)
        if valid is not None:
            p = torch.where(valid, p, torch.zeros_like(p))
        alpha = torch.exp2(m - m_next)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(v.dtype).float(), vb.float())
        m = m_next
    l_div = torch.where(l == 0, torch.ones_like(l), l)
    out = (acc / l_div).to(q.dtype).permute(0, 2, 1, 3)
    return out, m[..., 0], l[..., 0]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          k_lens: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None,
                          block_k: int = 512) -> torch.Tensor:
    """The forward kernel's plain twin: the output of
    ``flash_attention_stats_plain``."""
    return flash_attention_stats_plain(q, k, v, k_lens, scale, block_k)[0]


def flash_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    k_lens: Optional[torch.Tensor], o: torch.Tensor,
                    m: torch.Tensor, l: torch.Tensor, do: torch.Tensor,
                    scale: Optional[float] = None, block_k: int = 512):
    """``_flash_bwd`` in plain PyTorch, over key blocks of ``block_k``
    (memory O(B·N·Lq·block_k)), all in fp32: P = exp2(s − m)·(1/l) with
    1/l guarded at l = 0, Δ = rowsum(o·do), dS = P·(dP − Δ); dq = dS·k
    times ``scale``, dk = dSᵀ·q' over log2 e, dv = Pᵀ·do, each cast to its
    input's dtype. m, l: [B, N, Lq] fp32 (base 2). Returns (dq, dk, dv) in
    the [B, L, N, D] layout."""
    b, lq, n, d = q.shape
    lk = k.shape[1]
    if scale is None:
        scale = d ** -0.5
    qs = _prescale(q, scale)
    dof = do.to(q.dtype).permute(0, 2, 1, 3).float()
    delta = (o.float() * do.float()).sum(-1).permute(0, 2, 1)[..., None]
    l = l.float()[..., None]
    l_inv = torch.where(l == 0, torch.ones_like(l), 1.0 / l)
    m = m.float()[..., None]
    dq = torch.zeros((b, n, lq, d), dtype=torch.float32, device=q.device)
    dk = torch.empty((b, n, lk, d), dtype=torch.float32, device=q.device)
    dv = torch.empty((b, n, lk, d), dtype=torch.float32, device=q.device)
    for j0 in range(0, lk, block_k):
        kb = k[:, j0:j0 + block_k].permute(0, 2, 1, 3).float()
        vb = v[:, j0:j0 + block_k].permute(0, 2, 1, 3).float()
        j1 = j0 + kb.shape[2]
        s = torch.matmul(qs, kb.transpose(-1, -2))  # [B, N, Lq, bk]
        valid = _key_valid(k_lens, b, j0, kb.shape[2], q.device)
        if valid is not None:
            s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
        p = torch.exp2(s - m) * l_inv
        if valid is not None:  # also where m is -1e30 (no key attended)
            p = torch.where(valid, p, torch.zeros_like(p))
        dv[:, :, j0:j1] = torch.matmul(p.transpose(-1, -2), dof)
        dp = torch.matmul(dof, vb.transpose(-1, -2))
        ds = p * (dp - delta)
        dk[:, :, j0:j1] = torch.matmul(ds.transpose(-1, -2), qs)
        dq += torch.matmul(ds, kb)
    dq = dq * scale
    dk = dk * (1.0 / LOG2E)
    return (dq.to(q.dtype).permute(0, 2, 1, 3),
            dk.to(k.dtype).permute(0, 2, 1, 3),
            dv.to(v.dtype).permute(0, 2, 1, 3))


# ------------------------------------------------------------ the kernels


def _check_kernel_operand(name: str, x: torch.Tensor, device,
                          dtype: torch.dtype = torch.bfloat16) -> None:
    """bf16 operands (the TMA kernels): strides multiples of 8 elements,
    16-byte aligned; fp32 ones (``flash_fwd_f32.cu``, float2 loads): even
    strides, 8-byte aligned."""
    if not x.is_cuda or x.device != device:
        raise ValueError(f"flash kernel: {name} is not on {device}")
    if x.dtype != dtype:
        raise TypeError(f"flash kernel: {name} must be {dtype}, got "
                        f"{x.dtype}")
    step, align = (8, 16) if dtype == torch.bfloat16 else (2, 8)
    if x.stride(-1) != 1 or any(s % step for s in x.stride()[:-1]):
        raise ValueError(
            f"flash kernel: {name} needs unit stride on D and strides that "
            f"are multiples of {step} elements, got {tuple(x.stride())}")
    if x.data_ptr() % align:
        raise ValueError(f"flash kernel: {name} is not {align}-byte aligned")


def _check_qkv(q, k, v, k_lens, dtype: torch.dtype = torch.bfloat16):
    """Validate q/k/v for the bf16 kernels or, with ``dtype`` fp32, the
    fp32 forward; returns (b, lq, lk, n, d, k_lens as a contiguous int32
    device tensor or None)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash kernel: q, k, v must be [B, L, N, D]")
    b, lq, n, d = q.shape
    lk = k.shape[1]
    if dtype == torch.bfloat16 and d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel: head dim D={d} is not supported "
                         f"in bf16 (supported: {KERNEL_HEAD_DIMS})")
    if dtype == torch.float32 and (d % 8 or not 0 < d <= F32_MAX_HEAD_DIM):
        raise ValueError(f"flash kernel: head dim D={d} is not supported "
                         "in fp32 (a multiple of 8 up to "
                         f"{F32_MAX_HEAD_DIM})")
    if k.shape != (b, lk, n, d) or v.shape != k.shape:
        raise ValueError(f"flash kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_kernel_operand(name, x, q.device, dtype)
    if k_lens is not None:
        if k_lens.shape != (b,):
            raise ValueError(f"flash kernel: k_lens must be [{b}], got "
                             f"{tuple(k_lens.shape)}")
        k_lens = k_lens.to(device=q.device, dtype=torch.int32).contiguous()
    return b, lq, lk, n, d, k_lens


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def _kernel_fn(lib_name: str, fn_name: str, argtypes):
    from .. import kernels

    fn = getattr(kernels.load(lib_name), fn_name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


_FWD_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p])
_FWD_STATS_ARGS = [ctypes.c_void_p] * 2 + _FWD_ARGS
_BWD_DKV_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
_BWD_DQ_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                   ctypes.c_void_p])


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _fwd_cuda(q, k, v, k_lens, scale, stats: bool):
    """Launch the forward kernel, or its stats variant, on the current
    stream: out, plus (m, l) [B, N, Lq] fp32 with ``stats``."""
    b, lq, lk, n, d, k_lens = _check_qkv(q, k, v, k_lens)
    if scale is None:
        scale = d ** -0.5
    out = torch.empty((b, lq, n, d), dtype=q.dtype, device=q.device)
    ml = [torch.empty((b, n, lq), dtype=torch.float32, device=q.device)
          for _ in range(2 if stats else 0)]
    fn = _kernel_fn("flash_fwd", "flash_fwd_stats_bf16" if stats
                    else "flash_fwd_bf16",
                    _FWD_STATS_ARGS if stats else _FWD_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             *(x.data_ptr() for x in ml), _ptr(k_lens), b, n, lq, lk, d,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *out.stride()[:3], float(_qscale(scale, q.dtype)), _stream(q))
    _raise_on(err, "flash stats kernel" if stats else "flash kernel")
    return out, *ml


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         k_lens: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Launch the forward kernel of q's dtype on the current stream: bf16
    (D = 128) ``flash_fwd.cu``, fp32 ``flash_attention_f32_cuda``. Raises
    on what neither takes; never falls back. Not differentiable: see
    ``FlashAttention``."""
    if q.dtype == torch.float32:
        return flash_attention_f32_cuda(q, k, v, k_lens, scale)
    (out,) = _fwd_cuda(q, k, v, k_lens, scale, stats=False)
    flash_attention.launches += 1
    return out


def flash_attention_f32_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             k_lens: Optional[torch.Tensor] = None,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Launch the fp32 forward (``csrc/flash_fwd_f32.cu``) on the current
    stream: fp32 [B, L, N, D] with D a multiple of 8 up to 128, read
    through their strides (views of one fused qkv buffer need no copy).
    Raises on anything else; never falls back. Not differentiable."""
    b, lq, lk, n, d, k_lens = _check_qkv(q, k, v, k_lens, torch.float32)
    if scale is None:
        scale = d ** -0.5
    out = torch.empty((b, lq, n, d), dtype=q.dtype, device=q.device)
    fn = _kernel_fn("flash_fwd_f32", "flash_fwd_f32", _FWD_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             _ptr(k_lens), b, n, lq, lk, d, *q.stride()[:3],
             *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
             float(_qscale(scale, q.dtype)), _stream(q))
    _raise_on(err, "flash fp32 kernel")
    flash_attention.f32_launches += 1
    return out


def flash_attention_stats_cuda(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor,
                               k_lens: Optional[torch.Tensor] = None,
                               scale: Optional[float] = None):
    """Launch the stats forward kernel: (out, m, l) as
    ``flash_attention_stats_plain`` gives them."""
    out, m, l = _fwd_cuda(q, k, v, k_lens, scale, stats=True)
    flash_attention.stats_launches += 1
    return out, m, l


class BwdOperands(NamedTuple):
    """The backward kernels' operands, checked and prepared once for both
    (``bwd_operands``)."""
    qs: torch.Tensor      # q·bf16(scale·log2 e), [B, Lq, N, D] bf16
    k: torch.Tensor
    v: torch.Tensor
    dof: torch.Tensor     # dO cast to q's dtype, contiguous
    m: torch.Tensor       # [B, N, Lq] fp32, base 2
    l: torch.Tensor       # [B, N, Lq] fp32
    delta: torch.Tensor   # rowsum(o·dO), [B, N, Lq] fp32
    k_lens: Optional[torch.Tensor]
    scale: float


def bwd_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 k_lens: Optional[torch.Tensor], o: torch.Tensor,
                 m: torch.Tensor, l: torch.Tensor, do: torch.Tensor,
                 scale: Optional[float] = None) -> BwdOperands:
    """Check what the backward kernels take (raising on anything else)
    and do the plain-torch pre-pass that ``_flash_bwd`` does outside
    Pallas: the prescale of q, the cast of ``do`` and Δ = rowsum(o·do)."""
    b, lq, lk, n, d, k_lens = _check_qkv(q, k, v, k_lens)
    if scale is None:
        scale = d ** -0.5
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash backward: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} must match q {tuple(q.shape)}")
    for name, x in (("m", m), ("l", l)):
        if (x.shape != (b, n, lq) or x.dtype != torch.float32
                or not x.is_contiguous() or x.device != q.device):
            raise ValueError(f"flash backward: {name} must be fp32 "
                             f"[{b}, {n}, {lq}] contiguous on {q.device}")
    qs = q * _qscale(scale, q.dtype).to(q.device)
    dof = do.to(q.dtype).contiguous()
    _check_kernel_operand("do", dof, q.device)
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    return BwdOperands(qs, k, v, dof, m, l, delta, k_lens, float(scale))


def _bwd_launch(ops: BwdOperands, fn_name: str, argtypes, outs, what: str,
                out_scale: float, *extra) -> None:
    """Call one backward entry point: the operands, ``outs``, the shapes,
    the 15 strides, ``out_scale``, then ``extra`` and the stream."""
    b, lq, n, d = ops.qs.shape
    strides = (ctypes.c_longlong * 15)(
        *ops.qs.stride()[:3], *ops.k.stride()[:3], *ops.v.stride()[:3],
        *ops.dof.stride()[:3], *outs[0].stride()[:3])
    fn = _kernel_fn("flash_bwd", fn_name, argtypes)
    err = fn(ops.qs.data_ptr(), ops.k.data_ptr(), ops.v.data_ptr(),
             ops.dof.data_ptr(), ops.m.data_ptr(), ops.l.data_ptr(),
             ops.delta.data_ptr(), *(x.data_ptr() for x in outs),
             _ptr(ops.k_lens), b, n, lq, ops.k.shape[1], d, strides,
             out_scale, *extra, _stream(ops.qs))
    _raise_on(err, what)


# The dKV kernel's blocking: a block owns DKV_BLOCK_KEYS keys of one
# (batch, head) and walks the queries in tiles of DKV_QUERY_TILE rows, one
# block per SM. DKV_FULL_GRID blocks are two full rounds over an H100's
# 132 SMs.
DKV_BLOCK_KEYS = 128
DKV_QUERY_TILE = 64
DKV_FULL_GRID = 264
DKV_MIN_TILES_PER_CHUNK = 8


def dkv_query_splits(b: int, n: int, lq: int, lk: int) -> int:
    """Into how many chunks the dKV kernel's query loop is cut. With few
    keys (the 512-token cross-attention) there are fewer (key block, head,
    batch) triples than SMs; then the queries are shared out over as many
    chunks as still fit in ``DKV_FULL_GRID`` blocks, each chunk keeping at
    least ``DKV_MIN_TILES_PER_CHUNK`` query tiles. 1 where the keys alone
    fill the card. A pure function of the shapes, so the order of the
    sums, and with it every bit of dk and dv, is the same from run to
    run."""
    blocks = -(-lk // DKV_BLOCK_KEYS) * n * b
    tiles = -(-lq // DKV_QUERY_TILE)
    if blocks == 0:
        return 1
    return max(1, min(DKV_FULL_GRID // blocks,
                      tiles // DKV_MIN_TILES_PER_CHUNK))


def flash_bwd_dkv_cuda(ops: BwdOperands):
    """Launch the dKV kernel: (dk, dv), bf16 [B, Lk, N, D]. Where
    ``dkv_query_splits`` cuts the query loop, the chunks' fp32 partial
    sums go through a scratch tensor and a second small kernel adds them
    in chunk order; that is still one dKV computation and counts as one
    launch."""
    dk = torch.empty(ops.k.shape, dtype=ops.k.dtype, device=ops.k.device)
    dv = torch.empty(ops.v.shape, dtype=ops.v.dtype, device=ops.v.device)
    b, lk, n, d = ops.k.shape
    splits = dkv_query_splits(b, n, ops.qs.shape[1], lk)
    scratch = None
    if splits > 1:
        scratch = torch.empty((2, splits, b, lk, n, d), dtype=torch.float32,
                              device=ops.k.device)
    _bwd_launch(ops, "flash_bwd_dkv_bf16", _BWD_DKV_ARGS, (dk, dv),
                "flash dKV kernel", 1.0 / LOG2E, splits, _ptr(scratch))
    flash_attention.dkv_launches += 1
    return dk, dv


def flash_bwd_dq_cuda(ops: BwdOperands) -> torch.Tensor:
    """Launch the dQ kernel: dq, bf16 [B, Lq, N, D]."""
    dq = torch.empty(ops.qs.shape, dtype=ops.qs.dtype, device=ops.qs.device)
    _bwd_launch(ops, "flash_bwd_dq_bf16", _BWD_DQ_ARGS, (dq,),
                "flash dQ kernel", ops.scale)
    flash_attention.dq_launches += 1
    return dq


def flash_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   k_lens: Optional[torch.Tensor], o: torch.Tensor,
                   m: torch.Tensor, l: torch.Tensor, do: torch.Tensor,
                   scale: Optional[float] = None):
    """Launch the dKV and the dQ kernel: (dq, dk, dv) as
    ``flash_bwd_plain`` gives them."""
    ops = bwd_operands(q, k, v, k_lens, o, m, l, do, scale)
    dk, dv = flash_bwd_dkv_cuda(ops)
    return flash_bwd_dq_cuda(ops), dk, dv


# ------------------------------------------------------------- autograd


class FlashAttention(torch.autograd.Function):
    """The ``_flash`` custom VJP (flash_attention.py:462-481): the forward
    saves (q, k, v, out, m, l); the backward recomputes P from them. With
    ``use_kernel`` the CUDA kernels run (CUDA tensors only), else the
    plain twins (any device)."""

    @staticmethod
    def forward(ctx, q, k, v, k_lens, scale, use_kernel):
        fwd = flash_attention_stats_cuda if use_kernel \
            else flash_attention_stats_plain
        out, m, l = fwd(q, k, v, k_lens, scale)
        ctx.save_for_backward(q, k, v, out, m, l, k_lens)
        ctx.scale = scale
        ctx.use_kernel = use_kernel
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l, k_lens = ctx.saved_tensors
        bwd = flash_bwd_cuda if ctx.use_kernel else flash_bwd_plain
        dq, dk, dv = bwd(q, k, v, k_lens, out, m, l, dout, ctx.scale)
        return dq, dk, dv, None, None, None


def needs_grad(*xs: torch.Tensor) -> bool:
    """Whether autograd records an op on ``xs`` here."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    k_lens: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Fused non-causal attention over [B, L, N, D]. CUDA tensors run the
    Hopper kernels, CPU tensors their plain twins; under autograd through
    ``FlashAttention`` (stats forward + backward kernels), otherwise the
    forward-only kernel of q's dtype. fp32 CUDA tensors under autograd
    raise: no kernel differentiates fp32 (the CLIP tower, the one fp32
    caller, is never trained)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if needs_grad(q, k, v):
        if q.is_cuda and q.dtype != torch.bfloat16:
            raise NotImplementedError(
                f"flash attention: no kernel differentiates {q.dtype} on "
                "the card (the fp32 forward serves the CLIP tower, which is "
                "never trained); run it under torch.no_grad()")
        return FlashAttention.apply(q, k, v, k_lens, scale, q.is_cuda)
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, k_lens, scale)
    return flash_attention_plain(q, k, v, k_lens, scale)


def flash_attention_with_stats(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor,
                               k_lens: Optional[torch.Tensor] = None,
                               scale: Optional[float] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Forward + per-row softmax stats in the JAX layout: (out, m, l) with
    m, l [B, Lq, N] and m in natural-log units (flash_attention.py:
    498-512). Not differentiable."""
    fwd = flash_attention_stats_cuda if q.is_cuda \
        else flash_attention_stats_plain
    out, m, l = fwd(q, k, v, k_lens, scale)
    return (out, (m * (1.0 / LOG2E)).transpose(1, 2),
            l.transpose(1, 2))


def reset_launch_counts() -> None:
    for name in COUNTERS:
        setattr(flash_attention, name, 0)


def launch_counts() -> dict:
    return {name: getattr(flash_attention, name) for name in COUNTERS}


reset_launch_counts()
