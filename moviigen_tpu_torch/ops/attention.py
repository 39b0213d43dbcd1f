"""Unified attention entry point.

Counterpart of ``moviigen_tpu/ops/attention.py::attention``. Inputs are
``[B, L, N, D]``; optional ``k_lens`` masks keys beyond each sequence's
true length; the scale defaults to D**-0.5; q/k/v are cast to
``compute_dtype`` first. Bidirectional (no causal mask).

Backends:
- ``"auto"`` — ``ops.flash_attention.flash_attention``: the Hopper kernels
  for CUDA tensors, their plain twins for CPU tensors;
- ``"plain"`` — the plain twins on any device (the counterpart of the JAX
  ``"xla"`` backend, used to hold the kernels to account).

Both are differentiable: under autograd each goes through the
``FlashAttention`` function (stats forward, then the dKV and dQ
backward), so training memory stays O(L·block) like the JAX custom VJP.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..configs import ATTN_BACKENDS
from .flash_attention import (FlashAttention, flash_attention,
                              flash_attention_plain, needs_grad)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              k_lens: Optional[torch.Tensor] = None,
              scale: Optional[float] = None,
              backend: str = "auto",
              compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Multi-head attention over q [B, Lq, N, D], k/v [B, Lk, N, D]."""
    if backend not in ATTN_BACKENDS:
        raise ValueError(f"attention backend {backend!r} not in "
                         f"{ATTN_BACKENDS}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    q = q.to(compute_dtype)
    k = k.to(compute_dtype)
    v = v.to(compute_dtype)
    if backend == "auto":
        return flash_attention(q, k, v, k_lens, scale)
    if needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, k_lens, scale, False)
    return flash_attention_plain(q, k, v, k_lens, scale)
