"""Sequence-parallel DiT forward: Ulysses, ring and hybrid USP.

Counterpart of ``moviigen_tpu/parallel/ulysses.py``. The embedded tokens
are cut over the sequence axes of the mesh (``seq``, or ``ring`` × ``seq``
jointly) and, for the CFG pair, the batch over ``data``; every rank runs
the whole block stack on its share, and only the self-attention talks to
the other ranks:

- ``ulysses``: an all-to-all trades the token shard for a head shard,
  the forward kernel runs over the whole sequence with N/sp heads, and a
  second all-to-all trades back (FastVideo's ``all_to_all_4D``);
- ``ring``: the K/V shards rotate around the ring (``ring.py``), the
  carried kernel runs on each (query shard, key shard) pair, the key
  shards in natural order;
- ``usp``: Ulysses over the inner ``seq`` axis inside each ring group,
  then the ring over ``ring`` (the reference's ``--ulysses_size U
  --ring_size R``).

The cross-attention needs no communication: each rank's tokens query the
whole text (and, for i2v, the 257 image tokens). Under ``ring`` and
``usp`` the tokens are padded on to a multiple of ``KEY_TILE · sp``
(``sp_seq_len``), masked through ``k_lens`` as the caller's own padding
is, so that every key shard the ring walks is whole tiles of the kernel.
RoPE tables are padded with identity rotations to the padded length and
each rank takes its own rows. After the blocks the residual stream is
gathered over the sequence axes and over ``data``, and every rank runs
the head and unpatchify.

With ``fsdp_params`` the DiT's block weights are held as shards
(``sharding.shard_params``) and each block's are gathered just before it
runs (``sharding.make_param_gather``).

The forward is differentiable, with the gradients of JAX's ``shard_map``
transpose: every rank ends its backward holding the whole gradient of
each tensor it did not shard, and of each shard its own.

- The embedded inputs every rank computes alike enter the stack through
  ``Comm.shard`` (the tokens over the sequence axes, the rows over
  ``data``), whose backward gathers the ranks' gradients, and ``e0`` and
  the context through ``Comm.replicate`` over the sequence axes, whose
  backward sums them;
- the block stack's weights through the per-block gather
  (``make_param_gather``): shards gathered, the rest replicated over the
  mesh;
- the residual stream leaves through ``Comm.unshard``: every rank runs
  the head, unpatchify and the loss alike on the whole, so the backward
  keeps each rank's slice of the gradient (a reduce-scatter there would
  multiply the gradients by the world size).

``remat`` and ``remat_group`` checkpoint the blocks as ``run_blocks``
does, the per-block gathers inside.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..models.wan_model import WanModel, unpatchify
from ..ops.attention import attention
from ..ops.flash_attention import KEY_TILE
from ..ops.rope import RopeTables
from .comm import Axis, Comm
from .ring import ring_self_attention
from .sharding import make_param_gather, shard_axis

SP_MODES = ("ulysses", "ring", "usp")


def ulysses_self_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, k_lens: Optional[torch.Tensor],
                           comm: Comm, axis: Axis = "seq",
                           attn_backend: str = "auto",
                           compute_dtype: torch.dtype = torch.bfloat16
                           ) -> torch.Tensor:
    """[B, L/sp, N, D] token shards → attention over the full sequence
    with N/sp heads of this rank → back to [B, L/sp, N, D]. q, k and v are
    cast to ``compute_dtype`` before the exchange (what the attention
    would do after it), so half the bytes move in bf16."""
    q, k, v = (comm.all_to_all(x.to(compute_dtype), axis, 2, 1)
               for x in (q, k, v))
    out = attention(q, k, v, k_lens=k_lens, backend=attn_backend,
                    compute_dtype=compute_dtype)
    return comm.all_to_all(out, axis, 1, 2)


def sp_seq_len(seq_len: int, sp: int, sp_mode: str) -> int:
    """The token count the SP forward runs at for a (padded) ``seq_len``
    that divides by ``sp``: itself under ``ulysses``; under ``ring`` and
    ``usp`` rounded up to a multiple of ``KEY_TILE · sp``, so that each
    ring rank's key shard starts and ends on a tile of the kernel, where
    one card's kernel starts and ends one (1,950-key shards of r1's 7,800
    tokens over 4 ranks do not: they run as 2,048)."""
    if sp_mode == "ulysses":
        return seq_len
    unit = KEY_TILE * sp
    return -(-seq_len // unit) * unit


def _padded_rope(rope: RopeTables, seq_len: int):
    """cos/sin padded to ``seq_len`` rows with identity rotations (cos 1,
    sin 0), so every rank's rows are a slice of one table and padding
    tokens pass through unrotated, as ``rope_apply`` leaves them."""
    cos, sin = rope.cos, rope.sin
    pad = seq_len - cos.shape[0]
    if pad > 0:
        cos = torch.cat([cos, cos.new_ones((pad, cos.shape[1]))])
        sin = torch.cat([sin, sin.new_zeros((pad, sin.shape[1]))])
    return cos, sin


def _self_attn_fn(comm: Comm, sp_mode: str, attn_backend: str,
                  compute_dtype: torch.dtype):
    if sp_mode == "ring":
        def fn(q, k, v, kl):
            return ring_self_attention(q, k, v, kl, comm, "seq",
                                       attn_backend=attn_backend,
                                       compute_dtype=compute_dtype)
    elif sp_mode == "usp":
        def fn(q, k, v, kl):
            # Ulysses inside the ring group: heads scatter over 'seq' and
            # the tokens gather to this ring rank's contiguous block
            # [r·L/R, (r+1)·L/R) (ring-major token order)
            q2, k2, v2 = (comm.all_to_all(x.to(compute_dtype), "seq", 2, 1)
                          for x in (q, k, v))
            out = ring_self_attention(q2, k2, v2, kl, comm, "ring",
                                      attn_backend=attn_backend,
                                      compute_dtype=compute_dtype)
            return comm.all_to_all(out, "seq", 1, 2)
    else:
        def fn(q, k, v, kl):
            return ulysses_self_attention(q, k, v, kl, comm, "seq",
                                          attn_backend=attn_backend,
                                          compute_dtype=compute_dtype)
    return fn


def sequence_parallel_forward(
        model: WanModel, x: torch.Tensor, t: torch.Tensor,
        context: torch.Tensor, rope: RopeTables, comm: Comm,
        seq_len: Optional[int] = None,
        compute_dtype: torch.dtype = torch.bfloat16,
        attn_backend: str = "auto", sp_mode: str = "ulysses",
        fsdp_params: bool = False,
        residual_dtype: torch.dtype = torch.float32,
        remat: bool = False, remat_group: int = 1,
        clip_fea: Optional[torch.Tensor] = None,
        y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The DiT forward of ``WanModel.forward`` over this rank's share of
    a ``(data, seq)`` or ``(data, ring, seq)`` mesh; every rank returns the
    whole fp32 prediction [B, C_out, F, H, W]. ``sp_mode``:

    - ``ulysses``: on a (data, seq) mesh, num_heads divisible by seq;
    - ``ring``: on a (data, seq) mesh, any head count;
    - ``usp``: on a (data, ring, seq) mesh, num_heads divisible by seq.

    The (padded) sequence length must divide by the sequence axes' size
    and the batch by ``data``; ring and usp pad it further
    (``sp_seq_len``). ``fsdp_params``: ``model`` holds shards
    over the sequence axes (``sharding.shard_params``), gathered per
    block. ``remat``, ``remat_group``: see ``WanModel.run_blocks``."""
    cfg = model.cfg
    hybrid = "ring" in comm.axis_names
    axis = shard_axis(comm)  # the tokens' (and the weights') axes
    sp = comm.axis_size(axis)
    if sp_mode == "usp":
        if not hybrid:
            raise ValueError("sp_mode='usp' needs a (data, ring, seq) mesh")
        ulysses = comm.axis_size("seq")
        if cfg.num_heads % ulysses:
            raise ValueError(
                f"num_heads {cfg.num_heads} must divide by ulysses degree "
                f"{ulysses} (ref generate.py:238-239)")
    elif sp_mode == "ulysses":
        if hybrid:
            raise ValueError("pure ulysses runs on a (data, seq) mesh")
        if cfg.num_heads % sp:
            raise ValueError(
                f"num_heads {cfg.num_heads} must divide by seq axis {sp} "
                "(ref generate.py:238-239)")
    elif sp_mode == "ring":
        if hybrid:
            raise ValueError("pure ring runs on a (data, seq) mesh; use "
                             "sp_mode='usp' on a (data, ring, seq) mesh")
    else:
        raise ValueError(f"unknown sp_mode: {sp_mode}")
    model.check_inputs(clip_fea, y)

    xt, e, e0, ctx, grid, k_lens = model.embed_inputs(
        x, t, context, seq_len=seq_len, compute_dtype=compute_dtype,
        clip_fea=clip_fea, y=y)
    b, l = xt.shape[:2]
    data = comm.axis_size("data")
    if l % sp:
        raise ValueError(f"(padded) seq_len {l} must be a multiple of "
                         f"sp={sp} (ref text2video.py:164-166)")
    if b % data:
        raise ValueError(f"batch {b} must divide by the data axis {data}")
    if k_lens is None:
        k_lens = torch.full((b,), l, dtype=torch.int32, device=xt.device)
    padded = sp_seq_len(l, sp, sp_mode)
    if padded > l:
        xt = F.pad(xt, (0, 0, 0, padded - l))
        l = padded
    cos, sin = _padded_rope(rope, l)

    bs, ls = b // data, l // sp
    rows = slice(comm.axis_index("data") * bs,
                 (comm.axis_index("data") + 1) * bs)
    toks = slice(comm.axis_index(axis) * ls, (comm.axis_index(axis) + 1) * ls)

    xs = comm.shard(comm.shard(xt, "data", 0), axis, 1)
    e0s = comm.replicate(comm.shard(e0, "data", 0), axis)
    ctxs = comm.replicate(comm.shard(ctx, "data", 0), axis)
    xr = model.run_blocks(
        xs.to(residual_dtype), e0s, ctxs,
        RopeTables(cos=cos[toks], sin=sin[toks]), k_lens[rows],
        compute_dtype, attn_backend, remat=remat, remat_group=remat_group,
        self_attn_fn=_self_attn_fn(comm, sp_mode, attn_backend,
                                   compute_dtype),
        param_gather_fn=make_param_gather(comm, axis)
        if fsdp_params or torch.is_grad_enabled() else None)
    xr = comm.unshard(comm.unshard(xr, axis, 1), "data", 0)
    out = model.head_output(xr, e)
    return unpatchify(out, grid, cfg.patch_size, cfg.out_dim)
