"""Operations and bytes of the DiT's work, from its shapes: the yardstick of
the ``mfu.*`` and ``*_roofline`` metrics. One function per model family
(here the Wan DiT, t2v).

``dit_flops`` is copied from ``bench_torch.py::dit_flops`` (commit
503dac0), with the sizes read from the configuration file's ``model``
group instead of the port's config object.
"""

from __future__ import annotations

BF16_BYTES = 2


def dit_flops(m: dict, tokens: int, batch: int = 1) -> float:
    """Flops of one DiT forward: per block the self-attention's q, k, v, o
    projections (8·L·d²) and its two products (4·L²·d), the
    cross-attention's q and o projections (4·L·d²), its k and v over the
    text tokens (4·Lt·d²) and its two products (4·L·Lt·d), and the FFN
    (4·L·d·f). The patch embedding, time embedding and head (under 0.1 %
    at 14B) are left out."""
    d, f, n, lt = m["dim"], m["ffn_dim"], m["num_layers"], m["text_len"]
    per_block = (12.0 * tokens * d * d + 4.0 * tokens * tokens * d
                 + 4.0 * lt * d * d + 4.0 * tokens * lt * d
                 + 4.0 * tokens * d * f)
    return batch * n * per_block


def attention_work(m: dict, tokens: int, batch: int = 1,
                   backward: bool = False):
    """(operations, bytes) the DiT's attention needs in one forward, and
    with ``backward`` in its backward as well, over all blocks: the
    self-attention L × L and the cross-attention L × Lt (Lt = text_len),
    at head width d = dim over all heads.

    Operations: the forward's two products, 4·Lq·Lk·d; the backward's
    four (dV, dP, dQ, dK), 8·Lq·Lk·d; nothing recomputed. Bytes, bf16:
    the forward reads q, k, v and writes o once; the backward reads q,
    k, v, o and do and writes dq, dk, dv once (the softmax statistics,
    Lq·heads·8 bytes, are left out: under 0.1 % at head width 128)."""
    d, n, lt = m["dim"], m["num_layers"], m["text_len"]
    ops = by = 0.0
    for lq, lk in ((tokens, tokens), (tokens, lt)):
        ops += 4.0 * lq * lk * d
        by += (2 * lq + 2 * lk) * d * BF16_BYTES
        if backward:
            ops += 8.0 * lq * lk * d
            by += (5 * lq + 3 * lk) * d * BF16_BYTES
    return batch * n * ops, batch * n * by


def tokens_of(m: dict, latent_shape) -> int:
    """Tokens of a latent [C, F, H, W] under the patch size."""
    pt, ph, pw = m["patch_size"]
    _, f, h, w = latent_shape
    return (f // pt) * (h // ph) * (w // pw)
