"""Ring attention: sequence-parallel attention with rotating K/V shards.

Counterpart of ``moviigen_tpu/parallel/ring.py`` (``_local_klens``,
``_ring_fwd_loop``, ``ring_self_attention`` and the ring-level custom VJP
``_ring_flash``). Each rank
keeps its query shard and passes its K/V shard around the ring
(``Comm.ring_shift``); at every step it runs the stats forward
(``ops.flash_attention.flash_attention_with_stats``: the ``flash_fwd.cu``
``kStats`` kernel on the card, its plain twin on the CPU) on the shard it
holds, with that shard's own valid key count, and merges the partial into
its accumulator with the online softmax (``ring_merge``). No rank ever
holds the whole sequence's K/V.

The merge runs in fp32 on natural-log stats, exactly as ``ring.py:106-117``
does: o, m and l are carried, o is renormalized at every step, and a row
that has attended to nothing (l = 0) is divided by 1. A key shard that
lies wholly in the padding arrives with ``k_len`` 0; the stats kernel
gives it m = -1e30 (base 2) and l = 0, so it adds nothing.

Under autograd the ring is one ``torch.autograd.Function``
(``RingAttention``, the JAX ``_ring_flash_fwd`` / ``_ring_flash_bwd``).
The forward keeps only the home shards and the merged (o, m, l); the
backward rotates K/V again (rematerialized, never saved) together with
fp32 dK/dV accumulators, and at each of the sp steps runs one pair
backward (``flash_bwd_cuda``: the dKV and dQ kernels on the card,
``flash_bwd_plain`` on the CPU) with the **global** stats and the held
shard's own key count. The flash backward splits exactly over key shards
given the global (m, l) and Δ = rowsum(o·dO) of the global o, so the
pairs' dq add up on the rank and each dk/dv accumulator, rotated with its
shard, comes home with the last rotation. A pair whose shard has
``k_len`` 0 has P = 0 and adds exactly zero.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.flash_attention import (LOG2E, flash_attention_with_stats,
                                   flash_bwd_cuda, flash_bwd_plain)
from .comm import Axis, Comm

_NEG_INF = -1e30


def _local_klens(k_lens: Optional[torch.Tensor], src: int,
                 shard: int) -> Optional[torch.Tensor]:
    """Global per-batch key length → the valid length inside the shard
    that started on rank ``src`` (keys [src·shard, (src + 1)·shard))."""
    if k_lens is None:
        return None
    return (k_lens - src * shard).clamp(0, shard).to(torch.int32)


def ring_merge(o_acc: torch.Tensor, m_acc: torch.Tensor,
               l_acc: torch.Tensor, o_p: torch.Tensor, m_p: torch.Tensor,
               l_p: torch.Tensor):
    """One online-softmax merge step (``ring.py:106-117``): the
    accumulator (o_acc fp32 [B, Lq, N, D], normalized; m_acc, l_acc fp32
    [B, Lq, N]) and a partial (o_p normalized by l_p, any float dtype)
    → the merged (o, m, l), all fp32."""
    m_new = torch.maximum(m_acc, m_p)
    a_old = torch.exp(m_acc - m_new)
    a_new = torch.exp(m_p - m_new)
    o = o_acc * (l_acc * a_old)[..., None] \
        + o_p.float() * (l_p * a_new)[..., None]
    l = l_acc * a_old + l_p * a_new
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return o / l_safe[..., None], m_new, l


def _ring_fwd_loop(q, k, v, k_lens, comm: Comm, axis: Axis, scale,
                   backend):
    """The rotating-K/V forward; returns (o fp32, m, l) with the global
    (natural-log) softmax stats of the local query shard."""
    sp = comm.axis_size(axis)
    me = comm.axis_index(axis)
    b, lq, n, d = q.shape
    shard = k.shape[1]
    m_acc = torch.full((b, lq, n), _NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_acc = torch.zeros_like(m_acc)
    o_acc = torch.zeros((b, lq, n, d), dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    for step in range(sp):
        src = (me - step) % sp  # the rank the held shard started on
        o_p, m_p, l_p = flash_attention_with_stats(
            q, k_blk, v_blk, _local_klens(k_lens, src, shard), scale,
            backend)
        o_acc, m_acc, l_acc = ring_merge(o_acc, m_acc, l_acc, o_p, m_p, l_p)
        if step < sp - 1:
            k_blk = comm.ring_shift(k_blk, axis)
            v_blk = comm.ring_shift(v_blk, axis)
    return o_acc, m_acc, l_acc


class RingAttention(torch.autograd.Function):
    """The ring-level custom VJP (``ring.py:127-216``) over the rank's
    q/k/v shards (already in the compute dtype)."""

    @staticmethod
    def forward(ctx, q, k, v, k_lens, comm, axis, scale, backend):
        o, m, l = _ring_fwd_loop(q, k, v, k_lens, comm, axis, scale,
                                 backend)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, m, l, k_lens)
        ctx.args = (comm, axis, scale, backend)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, m, l, k_lens = ctx.saved_tensors
        comm, axis, scale, backend = ctx.args
        sp, me = comm.axis_size(axis), comm.axis_index(axis)
        shard = k.shape[1]
        # the pair backward takes the stats as the kernels keep them:
        # [B, N, Lq] fp32 contiguous, m in base 2 (the JAX m2 = m·log2 e)
        m2 = (m * LOG2E).transpose(1, 2).contiguous()
        l2 = l.transpose(1, 2).contiguous()
        do = g.to(q.dtype)
        bwd = flash_bwd_cuda if q.is_cuda and backend == "auto" \
            else flash_bwd_plain
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        k_blk, v_blk = k, v
        for step in range(sp):
            src = (me - step) % sp
            dq_p, dk_p, dv_p = bwd(q, k_blk, v_blk,
                                   _local_klens(k_lens, src, shard), out,
                                   m2, l2, do, scale)
            dq += dq_p.float()
            dk += dk_p.float()
            dv += dv_p.float()
            # the accumulators travel with their shard; the last rotation
            # (K/V no longer needed) brings every dk/dv home
            dk = comm._ring_shift(dk, axis)
            dv = comm._ring_shift(dv, axis)
            if step < sp - 1:
                k_blk = comm._ring_shift(k_blk, axis)
                v_blk = comm._ring_shift(v_blk, axis)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        k_lens: Optional[torch.Tensor], comm: Comm,
                        axis: Axis = "seq", scale: Optional[float] = None,
                        attn_backend: str = "auto",
                        compute_dtype: torch.dtype = torch.bfloat16
                        ) -> torch.Tensor:
    """q/k/v: [B, L/sp, N, D], this rank's shard along ``axis``; returns
    its queries' attention over the whole sequence in ``compute_dtype``.
    ``k_lens`` is the global key length per batch entry (the padded tail
    is masked). Differentiable (``RingAttention``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    q, k, v = (x.to(compute_dtype).contiguous() for x in (q, k, v))
    return RingAttention.apply(q, k, v, k_lens, comm, axis, scale,
                               attn_backend)
