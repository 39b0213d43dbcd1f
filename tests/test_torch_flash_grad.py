"""The port's flash attention under training: the stats forward, the
backward and the ``FlashAttention`` autograd function against the JAX
package.

On the CPU the port runs the kernels' plain twins; the Pallas kernels run
in interpreter mode, as ``tests/test_flash_attention.py`` runs them. The
CUDA kernels are held against the twins on the card in
``tests/test_torch_kernels_gpu.py``.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from moviigen_tpu.ops import flash_attention as jfa
from moviigen_tpu_torch.ops import flash_attention as tfa
from moviigen_tpu_torch.ops.attention import attention

_orig_pallas_call = pl.pallas_call
BLOCK = 128

# (q shape [B, Lq, N, D], Lk, k_lens): L not a multiple of the 128-row
# Pallas tile, a key mask, cross-attention
CASES = [
    ((2, 300, 2, 32), None, (300, 131)),
    ((1, 200, 3, 64), 77, None),
    ((2, 130, 2, 32), 512, (512, 200)),
]


def _interp():
    return mock.patch.object(jfa.pl, "pallas_call",
                             functools.partial(_orig_pallas_call,
                                               interpret=True))


def _rand(shape, lk, seed):
    b, lq, n, d = shape
    lk = lk or lq
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, n, d)).astype(np.float32)
    k = rng.standard_normal((b, lk, n, d)).astype(np.float32)
    v = rng.standard_normal((b, lk, n, d)).astype(np.float32)
    do = rng.standard_normal((b, lq, n, d)).astype(np.float32)
    return q, k, v, do


def _klens(k_lens, jax_side):
    if k_lens is None:
        return None
    return jnp.asarray(k_lens, jnp.int32) if jax_side else \
        torch.tensor(k_lens, dtype=torch.int32)


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


# fp32 throughout: the tolerances of tests/test_flash_attention.py
@pytest.mark.parametrize("shape,lk,k_lens", CASES)
def test_stats_forward_matches_pallas(shape, lk, k_lens):
    q, k, v, _ = _rand(shape, lk, seed=sum(shape))
    with _interp():
        want = jfa.flash_attention_with_stats(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            k_lens=_klens(k_lens, True), block_q=BLOCK, block_k=BLOCK)
    got = tfa.flash_attention_with_stats(*_t(q, k, v),
                                         k_lens=_klens(k_lens, False))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("shape,lk,k_lens", CASES)
def test_backward_matches_pallas(shape, lk, k_lens):
    """The plain backward fed the Pallas forward's own (o, m, l) and the
    same dO gives ``_flash_bwd``'s (dq, dk, dv)."""
    q, k, v, do = _rand(shape, lk, seed=sum(shape) + 1)
    scale = shape[-1] ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    jkl = _klens(k_lens, True)
    with _interp():
        o, m, l = jfa._flash_fwd(jq, jk, jv, jkl, scale, BLOCK, BLOCK,
                                 return_stats=True)
        want = jfa._flash_bwd(jq, jk, jv, jkl, o, m, l, jdo, scale, BLOCK,
                              BLOCK)
    # the port keeps the stats as [B, N, Lq]
    m_t, l_t = (torch.from_numpy(np.asarray(x).transpose(0, 2, 1).copy())
                for x in (m, l))
    got = tfa.flash_bwd_plain(*_t(q, k, v), _klens(k_lens, False),
                              torch.from_numpy(np.array(o)), m_t, l_t,
                              torch.from_numpy(do), scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=1e-4)
    if k_lens is not None:  # keys past k_lens get exactly zero gradient
        for g in got[1:]:
            assert not bool(g[1, k_lens[1]:].any())


@pytest.mark.parametrize("chunks", [2, 3])
@pytest.mark.parametrize("shape,lk,k_lens", CASES)
def test_dkv_over_query_chunks_sums_to_the_whole(shape, lk, k_lens, chunks):
    """What the dKV kernel's split query loop relies on: with the global
    m, l and Δ = rowsum(o·do), dk and dv are sums over query rows, so the
    backward over chunks of the queries adds up to the backward over all
    of them (fp32; 1e-5 of the largest magnitude for the order of the
    sums), and to ``_flash_bwd``'s dk and dv."""
    q, k, v, do = _rand(shape, lk, seed=sum(shape) + 3)
    scale = shape[-1] ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    jkl = _klens(k_lens, True)
    with _interp():
        o, m, l = jfa._flash_fwd(jq, jk, jv, jkl, scale, BLOCK, BLOCK,
                                 return_stats=True)
        _, jdk, jdv = jfa._flash_bwd(jq, jk, jv, jkl, o, m, l, jdo, scale,
                                     BLOCK, BLOCK)
    tq, tk, tv, tdo = _t(q, k, v, do)
    to = torch.from_numpy(np.array(o))
    m_t, l_t = (torch.from_numpy(np.asarray(x).transpose(0, 2, 1).copy())
                for x in (m, l))
    tkl = _klens(k_lens, False)
    _, dk, dv = tfa.flash_bwd_plain(tq, tk, tv, tkl, to, m_t, l_t, tdo, scale)
    lq = shape[1]
    edges = [lq * c // chunks for c in range(chunks + 1)]
    parts = [tfa.flash_bwd_plain(tq[:, a:b], tk, tv, tkl, to[:, a:b],
                                 m_t[:, :, a:b], l_t[:, :, a:b],
                                 tdo[:, a:b], scale)
             for a, b in zip(edges, edges[1:])]
    for whole, want, idx in ((dk, jdk, 1), (dv, jdv, 2)):
        summed = sum(part[idx] for part in parts)
        assert float((summed - whole).abs().max()) <= \
            1e-5 * float(whole.abs().max())
        np.testing.assert_allclose(summed.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("b,n,lq,lk,lo,hi", [
    (1, 12, 32760, 32760, 1, 1),      # self-attention: the keys fill the card
    (1, 12, 32760, 512, 2, 64),       # the 1.3B's text cross-attention
    (2, 40, 7800, 7800, 1, 1),
    (1, 8, 5000, 512, 2, 9),
    (1, 12, 7800, 512, 2, 15),
    (1, 1, 64 * 8 * 1000, 128, 2, 264),  # never more blocks than a full grid
    (1, 8, 500, 512, 1, 1),           # too few query tiles to share out
    (1, 8, 64 * 16, 64, 2, 2),
    (0, 8, 100, 100, 1, 1),
])
def test_dkv_query_splits(b, n, lq, lk, lo, hi):
    s = tfa.dkv_query_splits(b, n, lq, lk)
    assert lo <= s <= hi
    tiles = -(-lq // tfa.DKV_QUERY_TILE)
    assert s == 1 or s <= tiles // tfa.DKV_MIN_TILES_PER_CHUNK
    blocks = -(-lk // tfa.DKV_BLOCK_KEYS) * n * b
    assert s == 1 or s * blocks <= tfa.DKV_FULL_GRID
    assert s == tfa.dkv_query_splits(b, n, lq, lk)


def test_backward_of_a_batch_entry_without_keys_is_zero():
    """k_lens = 0: the forward gives out = 0, m = -1e30, l = 0; the
    backward masks P explicitly, as the kernels do, so every gradient of
    that entry is exactly zero (exp2(s − m) alone would be 1 there)."""
    q, k, v, do = _t(*_rand((2, 40, 2, 16), 24, seed=11))
    kl = torch.tensor([24, 0], dtype=torch.int32)
    out, m, l = tfa.flash_attention_stats_plain(q, k, v, kl)
    assert not bool(out[1].any())
    dq, dk, dv = tfa.flash_bwd_plain(q, k, v, kl, out, m, l, do)
    for g in (dq, dk, dv):
        assert not bool(g[1].any())
        assert bool(g[0].abs().max() > 0)


@pytest.mark.parametrize("backend", ["auto", "plain"])
@pytest.mark.parametrize("shape,lk,k_lens", CASES[:2])
def test_autograd_matches_jax_grad(shape, lk, k_lens, backend):
    """torch autograd through ``attention`` against ``jax.grad`` through
    the Pallas ``flash_attention`` custom VJP: atol/rtol 1e-3, the JAX
    suite's own for its Pallas backward."""
    q, k, v, do = _rand(shape, lk, seed=sum(shape) + 2)

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, k_lens=_klens(k_lens, True),
                                  block_q=BLOCK, block_k=BLOCK)
        return jnp.sum(out * jnp.asarray(do))

    with _interp():
        want = jax.grad(jloss, argnums=(0, 1, 2))(
            *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    out = attention(tq, tk, tv, k_lens=_klens(k_lens, False),
                    backend=backend, compute_dtype=torch.float32)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(do))
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3,
                                   rtol=1e-3)


def test_autograd_in_bf16_keeps_dtypes():
    """bf16 q/k/v give bf16 gradients through the Function, the output
    keeps its graph, and the CPU path launches no kernel."""
    q, k, v, do = _rand((1, 64, 2, 128), None, seed=5)
    tfa.reset_launch_counts()
    tq, tk, tv = (x.to(torch.bfloat16).requires_grad_()
                  for x in _t(q, k, v))
    out = tfa.flash_attention(tq, tk, tv)
    out.backward(torch.from_numpy(do).to(torch.bfloat16))
    for x in (tq, tk, tv):
        assert x.grad.dtype == torch.bfloat16
        assert bool(torch.isfinite(x.grad.float()).all())
        assert bool(x.grad.abs().max() > 0)
    assert tfa.launch_counts() == dict.fromkeys(tfa.COUNTERS, 0)


def test_no_grad_takes_the_forward_path():
    q, k, v, _ = _rand((1, 32, 2, 16), None, seed=6)
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    with torch.no_grad():
        out = tfa.flash_attention(tq, tk, tv)
    assert out.grad_fn is None
    assert tfa.flash_attention(*_t(q, k, v)).grad_fn is None


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 16, 2, 128, dtype=torch.bfloat16)
    m = torch.zeros(1, 2, 16)
    with pytest.raises(ValueError, match="not on"):
        tfa.flash_attention_stats_cuda(q, q, q)
    with pytest.raises(ValueError, match="not on"):
        tfa.flash_bwd_cuda(q, q, q, None, q, m, m, q)
