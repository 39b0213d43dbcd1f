"""Ring attention, the forward: sequence-parallel attention with rotating
K/V shards.

Counterpart of the forward of ``moviigen_tpu/parallel/ring.py``
(``_local_klens``, ``_ring_fwd_loop``, ``ring_self_attention``). Each rank
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

The backward (the JAX ring-level custom VJP) is not ported: under
autograd ``ring_self_attention`` raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.flash_attention import flash_attention_with_stats, needs_grad
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


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        k_lens: Optional[torch.Tensor], comm: Comm,
                        axis: Axis = "seq", scale: Optional[float] = None,
                        attn_backend: str = "auto",
                        compute_dtype: torch.dtype = torch.bfloat16
                        ) -> torch.Tensor:
    """q/k/v: [B, L/sp, N, D], this rank's shard along ``axis``; returns
    its queries' attention over the whole sequence in ``compute_dtype``.
    ``k_lens`` is the global key length per batch entry (the padded tail
    is masked)."""
    if needs_grad(q, k, v):
        raise NotImplementedError(
            "ring attention has no backward in the PyTorch port yet: "
            "training under sequence parallelism is ROADMAP item 11b; run "
            "the forward under torch.no_grad()")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    q, k, v = (x.to(compute_dtype).contiguous() for x in (q, k, v))
    o, _, _ = _ring_fwd_loop(q, k, v, k_lens, comm, axis, scale,
                             attn_backend)
    return o.to(compute_dtype)
