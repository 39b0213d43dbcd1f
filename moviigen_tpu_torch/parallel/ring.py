"""Ring attention: sequence-parallel attention with rotating K/V shards.

Counterpart of ``moviigen_tpu/parallel/ring.py`` (``_local_klens``,
``_ring_fwd_loop``, ``ring_self_attention`` and the ring-level custom VJP
``_ring_flash``). Each rank
keeps its query shard and passes its K/V shard around the ring
(``Comm._ring_shift``: both loops run with grad off) and runs
``ops.flash_attention.flash_attention_carry`` (the ``flash_fwd.cu``
``kCarry`` kernel on the card, its plain twin on the CPU) on each key
shard with that shard's own valid key count.

The forward walks the key shards in natural order, 0 to sp − 1, on every
rank (``natural_order``): the shards travel one rank down per step, and a
rank holds each shard that reaches it before its turn. Rank 0 receives
them in order and holds none; rank 1 holds the most, sp − 1. Where the
shards are whole tiles of the kernel (``KEY_TILE`` keys:
``ulysses.sequence_parallel_forward`` pads ring and USP sequences to a
multiple of ``KEY_TILE · sp``) every query row then sees the keys in the
order and the tiles one card's kernel walks, and its running max, the m
that P is rounded against, is one card's; the kernel's state also keeps
each thread's share of l (``CarryState.l_part``), so l is summed as one
card sums it, and the output is one card's kernel's, bit for bit. The
JAX ring walks the shards in rotated order (``ring.py:87-117``), which
changes every rank's maxima but rank 0's.

Where no gradient is taken (serving), the shifts overlap the kernels, as
XLA's async collectives overlap the JAX ring's ``ppermute``s
(``ring.py:12-13``): at each step a rank starts the shift of the shard
it just received (``Comm.ring_shift_start``, on the card from the comm's
own stream, waiting only for that shard) before it launches the step's
kernels, and waits for a shard only where it first attends to it. So
every shift waits for the shift before it, not for a kernel: rank 1
starts its sp kernels once sp − 1 shifts have brought it shard 0, where
synchronous shifts made it start them after sp − 2 of rank 0's kernels
(2·sp − 2 kernel times a ring attention). The carried kernel's grid is
persistent and holds every SM, so a kernel launched while an NCCL shift
is in flight leaves ``RING_SPARE_SMS`` SMs to NCCL's kernels
(``spare_sms``; the same bits at any grid). Under a training step
(autograd records the ring) the shifts stay synchronous on the compute
stream, forward and backward: overlapped, the 1.3B's ring step over four
H100s took 2.84 s where it took 1.69, its shifts at 4 CTAs on the capped
group and each pair's K/V queued behind the fp32 dK/dV on the one shift
stream (PERF.md §6; ``tools/ring_overlap_probe.py --train`` keeps that
schedule to try a repair on).

The online softmax is carried through the kernel: each step resumes from
the fp32 state the last one left (the unnormalized output, m in base 2
and l) and the last step writes the output, divided by l once (by 1
where l = 0), with the global stats. So each output is rounded to bf16
once, as on one card. The JAX ring instead merges each shard's
normalized partial, bf16 there, into an fp32 accumulator in natural-log
units (``ring.py:106-117``); ``ring_merge`` keeps that form of the
merge, which no path of the port runs. A key shard that lies wholly in
the padding arrives with ``k_len`` 0 and passes the state through.

Under autograd the ring is one ``torch.autograd.Function``
(``RingAttention``, the JAX ``_ring_flash_fwd`` / ``_ring_flash_bwd``).
The forward keeps only the home shards and the final (out, m, l); the
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

from typing import List, Optional

import torch

from ..ops.flash_attention import (flash_attention_carry, flash_bwd_cuda,
                                   flash_bwd_plain)
from .comm import COMM_CTAS, Axis, Comm, Pending, ready

_NEG_INF = -1e30
# SMs the carried kernel leaves to NCCL while a shift is in flight on a
# communication stream: the CTAs a shift's kernel may take
# (``comm.COMM_CTAS``). At S7's shards the kernel then runs 3-5 % slower
# (sms - 8 blocks), where a shift that waits for the full grid's end
# costs a whole kernel time of every later rank
# (tools/ring_overlap_probe.py).
RING_SPARE_SMS = COMM_CTAS


def _spare_sms(blk) -> int:
    """``RING_SPARE_SMS`` where a shift of ``blk`` runs on a
    communication stream (NCCL on the card), else 0: thread ranks and
    gloo return finished shifts, which need no SM."""
    return RING_SPARE_SMS if any(isinstance(x, Pending) and x.event
                                 is not None for x in blk) else 0


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
    """One online-softmax merge step of the JAX ring (``ring.py:106-117``):
    the accumulator (o_acc fp32 [B, Lq, N, D], normalized; m_acc, l_acc
    fp32 [B, Lq, N]) and a partial (o_p normalized by l_p, any float
    dtype) → the merged (o, m, l), all fp32. Not on the port's path (the
    ring carries its state through ``flash_attention_carry``); kept as the
    reference form of the merge."""
    m_new = torch.maximum(m_acc, m_p)
    a_old = torch.exp(m_acc - m_new)
    a_new = torch.exp(m_p - m_new)
    o = o_acc * (l_acc * a_old)[..., None] \
        + o_p.float() * (l_p * a_new)[..., None]
    l = l_acc * a_old + l_p * a_new
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return o / l_safe[..., None], m_new, l


def natural_order(sp: int, me: int) -> List[List[int]]:
    """Rank ``me``'s walk over ``sp`` key shards in natural order. The
    shards move one rank down a step (``_ring_shift(x, axis, -1)``: after
    s shifts rank ``me`` holds the shard that started on rank (me + s) %
    sp); each is attended to as soon as every lower one has been, and is
    held until then. Returns the shards attended to at each of the sp
    steps: rank 0 one a step, rank me > 0 none until shard 0 arrives at
    step sp − me, then shards 0 … me − 1 one a step, and shards me … sp − 1
    at the last step."""
    steps, held, nxt = [], set(), 0
    for step in range(sp):
        held.add((me + step) % sp)
        now = []
        while nxt in held:
            held.remove(nxt)
            now.append(nxt)
            nxt += 1
        steps.append(now)
    return steps


def _ring_fwd_loop(q, k, v, k_lens, comm: Comm, axis: Axis, scale,
                   backend, overlap: bool = True):
    """The rotating-K/V forward in natural key order: (out in q's dtype,
    m base 2, l), the global softmax stats [B, N, Lq] of the local query
    shard. Each step passes the shard it received on before it attends
    to what it may: with ``overlap``, a shift started
    (``Comm.ring_shift_start``) and waited for where its shard is first
    attended to; else a synchronous shift."""
    sp = comm.axis_size(axis)
    me = comm.axis_index(axis)
    shard = k.shape[1]
    state = None
    held = {}  # shard → its (k, v), tensors or shifts in flight
    blk = (k, v)
    for step, todo in enumerate(natural_order(sp, me)):
        held[(me + step) % sp] = blk
        spare = 0
        if step < sp - 1 and overlap:
            blk = tuple(comm.ring_shift_start(x, axis, -1) for x in blk)
            spare = _spare_sms(blk)
        elif step < sp - 1:
            blk = tuple(comm._ring_shift(x, axis, -1) for x in blk)
        for j in todo:
            k_j, v_j = (ready(x) for x in held.pop(j))  # freed once used
            state = flash_attention_carry(
                q, k_j, v_j, _local_klens(k_lens, j, shard), state,
                last=j == sp - 1, scale=scale, backend=backend,
                spare_sms=spare)
    return state


class RingAttention(torch.autograd.Function):
    """The ring-level custom VJP (``ring.py:127-216``) over the rank's
    q/k/v shards (already in the compute dtype). The forward overlaps its
    shifts only where no gradient is taken (serving): under a training
    step the overlapped ring measured slower on four H100s (PERF.md §6),
    so there, forward and backward, it shifts synchronously."""

    @staticmethod
    def forward(ctx, q, k, v, k_lens, comm, axis, scale, backend):
        out, m, l = _ring_fwd_loop(q, k, v, k_lens, comm, axis, scale,
                                   backend,
                                   overlap=not any(ctx.needs_input_grad[:3]))
        ctx.save_for_backward(q, k, v, out, m, l, k_lens)
        ctx.args = (comm, axis, scale, backend)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, m, l, k_lens = ctx.saved_tensors
        comm, axis, scale, backend = ctx.args
        sp, me = comm.axis_size(axis), comm.axis_index(axis)
        shard = k.shape[1]
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
                                   m, l, do, scale)
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
