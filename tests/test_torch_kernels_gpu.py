"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``gpu`` and skips without a CUDA device.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed; there, skip the suite's JAX conftest:

    python -m pytest --noconftest -q tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

from moviigen_tpu_torch.ops import flash_attention as tfa
from moviigen_tpu_torch.ops import int8_gemm as tig
from moviigen_tpu_torch.ops import quantization as tq
from moviigen_tpu_torch.ops.attention import attention
from moviigen_tpu_torch.ops.quantization import QuantLinear

pytestmark = pytest.mark.gpu

# chip_smoke.py's tolerance: 1e-2 of the output's largest magnitude (bf16
# output rounding on both sides, P rounded at different key blocks)
REL_TOL = 1e-2
# Gradients: the kernels round P and dS to bf16 (8 bits) before the
# tensor-core products that the plain twin does in fp32, and write bf16;
# the rounding errors are independent from term to term and mostly
# average out over the Lq or Lk terms of each sum, so the result stays
# within a few bf16 steps of its scale. 2e-2 of the largest magnitude
# bounds that; a wrong fragment, mask or scale is off by O(1) of it.
GRAD_REL_TOL = 2e-2

SHAPES = [
    (2, 1000, 1000, None),            # ragged q and k tiles
    (2, 777, 512, None),              # cross-attention shape
    (2, 1000, 1000, (1000, 600)),     # per-batch key mask, tiles past it
    (1, 64, 1, None),                 # a single key
]
# With one key the softmax is constant and dq is 0 up to rounding, which
# no relative bound can hold; the backward takes three keys there. Then:
# few keys and many queries, where the dKV query loop is split into chunks
# (``dkv_query_splits``); k_lens inside a key tile, a second key block that
# is partly past Lk, and a batch entry with one key; Lq under one tile.
SPLIT_SHAPE = (1, 5000, 512, None)
BWD_SHAPES = SHAPES[:3] + [(1, 64, 3, None), SPLIT_SHAPE,
                           (2, 130, 70, (70, 1)), (1, 40, 200, None)]
# The forward's 128-row query blocks and 128-key tiles: the backward's edge
# shapes (Lk under one tile, k_lens inside a tile and a batch entry with
# one key, Lq under one tile, few keys and many queries), and a batch entry
# with no key at all, which gives zeros, m = -1e30 and l = 0 (at 2,000
# rows, where a block of the persistent grid walks items of both entries).
FWD_SHAPES = SHAPES + BWD_SHAPES[3:] + [(2, 2000, 1000, (1000, 0))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, tol=REL_TOL):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * float(want.float().abs().max())


def _qkv(gen, b, lq, lk, requires_grad=False):
    return [torch.randn(b, l, 8, 128, generator=gen, device="cuda",
                        dtype=torch.bfloat16).requires_grad_(requires_grad)
            for l in (lq, lk, lk)]


def _klens(k_lens):
    return None if k_lens is None else torch.tensor(k_lens, device="cuda")


def _close_fwd(got, want, k_lens):
    """out (and m, l) against the plain twin; a batch entry with no key
    must give exactly out = 0, m = -1e30 and l = 0, and is left out of the
    relative bound (its m would make the bound meaningless)."""
    keep = list(range(got[0].shape[0]))
    if k_lens is not None and 0 in k_lens:
        i = k_lens.index(0)
        keep.remove(i)
        for g, zero in zip(got, (0.0, -1e30, 0.0)):
            assert bool((g[i] == zero).all())
    for g, w in zip(got, want):
        _close(g[keep], w[keep])


@pytest.mark.parametrize("b,lq,lk,k_lens", FWD_SHAPES)
def test_flash_kernel_matches_plain(cuda, b, lq, lk, k_lens):
    q, k, v = _qkv(cuda, b, lq, lk)
    kl = _klens(k_lens)
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, kl)
    assert tfa.flash_attention.launches == before + 1
    _close_fwd((got,), (tfa.flash_attention_plain(q, k, v, kl),), k_lens)


@pytest.mark.parametrize("b,lq,lk,k_lens", FWD_SHAPES)
def test_stats_kernel_matches_plain(cuda, b, lq, lk, k_lens):
    q, k, v = _qkv(cuda, b, lq, lk)
    kl = _klens(k_lens)
    before = tfa.flash_attention.stats_launches
    got = tfa.flash_attention_stats_cuda(q, k, v, kl)
    assert tfa.flash_attention.stats_launches == before + 1
    _close_fwd(got, tfa.flash_attention_stats_plain(q, k, v, kl), k_lens)


@pytest.mark.parametrize("b,lq,lk", [(1, 5000, 5000), SPLIT_SHAPE[:3]])
def test_forward_kernels_are_deterministic(cuda, b, lq, lk):
    """Each block owns its query rows and sums its keys in one order:
    the same bits from run to run."""
    q, k, v = _qkv(cuda, b, lq, lk)
    assert torch.equal(tfa.flash_attention_cuda(q, k, v),
                       tfa.flash_attention_cuda(q, k, v))
    first = tfa.flash_attention_stats_cuda(q, k, v)
    second = tfa.flash_attention_stats_cuda(q, k, v)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("b,lq,lk,k_lens", BWD_SHAPES)
def test_backward_kernels_match_plain(cuda, b, lq, lk, k_lens):
    q, k, v = _qkv(cuda, b, lq, lk)
    kl = _klens(k_lens)
    out, m, l = tfa.flash_attention_stats_plain(q, k, v, kl)
    do = torch.randn(out.shape, generator=cuda, device="cuda",
                     dtype=torch.bfloat16)
    counts = tfa.launch_counts()
    got = tfa.flash_bwd_cuda(q, k, v, kl, out, m, l, do)
    after = tfa.launch_counts()
    assert after["dkv_launches"] == counts["dkv_launches"] + 1
    assert after["dq_launches"] == counts["dq_launches"] + 1
    want = tfa.flash_bwd_plain(q, k, v, kl, out, m, l, do)
    for g, w in zip(got, want):
        _close(g.contiguous(), w.contiguous(), GRAD_REL_TOL)
    if k_lens is not None:  # keys past k_lens get exactly zero gradient
        for g in got[1:]:
            assert not bool(g[1, k_lens[1]:].any())


def test_attention_grads_on_cuda_match_plain(cuda):
    """Under autograd the kernel path keeps q, k and v in the graph (the
    forward kernel alone would cut them out) and gives the plain path's
    gradients."""
    base = _qkv(cuda, 2, 600, 600)
    kl = _klens((600, 333))
    do = torch.randn(base[0].shape, generator=cuda, device="cuda",
                     dtype=torch.bfloat16)
    grads = {}
    for backend in ("auto", "plain"):
        q, k, v = (x.detach().clone().requires_grad_() for x in base)
        out = attention(q, k, v, k_lens=kl, backend=backend)
        assert out.grad_fn is not None
        out.backward(do)
        grads[backend] = (q.grad, k.grad, v.grad)
    for g, w in zip(grads["auto"], grads["plain"]):
        assert g is not None and bool(g.abs().max() > 0)
        _close(g, w, GRAD_REL_TOL)


def test_split_shape_splits_the_query_loop():
    b, lq, lk, _ = SPLIT_SHAPE
    assert tfa.dkv_query_splits(b, 8, lq, lk) > 1
    assert tfa.dkv_query_splits(1, 8, 5000, 5000) == 1


@pytest.mark.parametrize("b,lq,lk", [(1, 5000, 5000), SPLIT_SHAPE[:3]])
def test_backward_is_deterministic(cuda, b, lq, lk):
    q, k, v = _qkv(cuda, b, lq, lk)
    out, m, l = tfa.flash_attention_stats_cuda(q, k, v)
    do = torch.randn(out.shape, generator=cuda, device="cuda",
                     dtype=torch.bfloat16)
    first = tfa.flash_bwd_cuda(q, k, v, None, out, m, l, do)
    second = tfa.flash_bwd_cuda(q, k, v, None, out, m, l, do)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_kernel_reads_strided_views(cuda):
    """q/k/v as views into wider tensors (the kernels read [B, L, N, D]
    through their strides, no copies)."""
    qkv = torch.randn(2, 300, 3, 4, 128, generator=cuda, device="cuda",
                      dtype=torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    _close(tfa.flash_attention(q, k, v),
           tfa.flash_attention_plain(qc, kc, vc))
    out, m, l = tfa.flash_attention_stats_cuda(q, k, v)
    do = torch.randn(out.shape, generator=cuda, device="cuda",
                     dtype=torch.bfloat16)
    got = tfa.flash_bwd_cuda(q, k, v, None, out, m, l, do)
    want = tfa.flash_bwd_plain(qc, kc, vc, None, out, m, l, do)
    for g, w in zip(got, want):
        _close(g.contiguous(), w.contiguous(), GRAD_REL_TOL)


def test_stats_kernel_reads_strided_views(cuda):
    """The stats forward on q, k, v sliced from one fused [B, L, 3N, D]
    tensor, with a key mask: out, m and l as the plain twin gives them
    from contiguous copies."""
    n = 4
    qkv = torch.randn(2, 333, 3 * n, 128, generator=cuda, device="cuda",
                      dtype=torch.bfloat16)
    q, k, v = qkv[:, :, :n], qkv[:, :, n:2 * n], qkv[:, :, 2 * n:]
    assert not q.is_contiguous()
    kl = _klens((333, 100))
    got = tfa.flash_attention_stats_cuda(q, k, v, kl)
    want = tfa.flash_attention_stats_plain(q.contiguous(), k.contiguous(),
                                           v.contiguous(), kl)
    for g, w in zip(got, want):
        _close(g, w)


def test_backward_kernels_read_strided_views(cuda):
    """q, k, v as slices of one fused [B, L, 3N, D] tensor and a ``do``
    that is a view of a wider tensor: the tensor maps are built from the
    views' strides, nothing is copied but ``do``."""
    n = 4
    qkv = torch.randn(2, 333, 3 * n, 128, generator=cuda, device="cuda",
                      dtype=torch.bfloat16)
    q, k, v = qkv[:, :, :n], qkv[:, :, n:2 * n], qkv[:, :, 2 * n:]
    assert not q.is_contiguous() and k.data_ptr() != qkv.data_ptr()
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    kl = _klens((333, 100))
    out, m, l = tfa.flash_attention_stats_cuda(q, k, v, kl)
    do = torch.randn(2, 333, n, 256, generator=cuda, device="cuda",
                     dtype=torch.bfloat16)[..., 128:]
    assert not do.is_contiguous()
    got = tfa.flash_bwd_cuda(q, k, v, kl, out, m, l, do)
    want = tfa.flash_bwd_plain(qc, kc, vc, kl, out, m, l, do.contiguous())
    for g, w in zip(got, want):
        _close(g.contiguous(), w.contiguous(), GRAD_REL_TOL)
    for g in got[1:]:
        assert not bool(g[1, 100:].any())


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 16, 2, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="D=64"):
        tfa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="D=64"):
        tfa.flash_attention_stats_cuda(q, q, q)
    m = torch.zeros(1, 2, 16, device="cuda")
    with pytest.raises(ValueError, match="D=64"):
        tfa.flash_bwd_cuda(q, q, q, None, q, m, m, q)
    q = torch.zeros(1, 16, 2, 128, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16"):
        tfa.flash_attention(q, q, q)
    with pytest.raises(TypeError, match="bfloat16"):
        tfa.flash_attention_stats_cuda(q, q, q)
    with pytest.raises(TypeError, match="bfloat16"):
        tfa.flash_bwd_cuda(q, q, q, None, q, m, m, q)
    # a backward operand whose head stride is not a multiple of 8 elements
    q = torch.zeros(1, 16, 2, 128, device="cuda", dtype=torch.bfloat16)
    k = torch.zeros(1, 16, 2, 132, device="cuda",
                    dtype=torch.bfloat16)[..., :128]
    with pytest.raises(ValueError, match="multiples of 8"):
        tfa.flash_bwd_cuda(q, k, q, None, q, m, m, q)


# ------------------------------------------------------ the fp32 forward

# fp32 kernel vs plain twin: both are full fp32 (no TF32) and differ only
# in the order of their sums (64-key tiles against 512-key blocks, four
# partial dot products joined by shuffles against cuBLAS); that moves the
# output by a few fp32 ulps of its scale (~1e-7). 1e-5 of the output's
# largest magnitude bounds that with margin; a wrong tile, mask or scale
# is off by O(1).
F32_REL_TOL = 1e-5
# (B, Lq, Lk, N, D, k_lens): the CLIP tower's shape (257 tokens, 16 heads
# of 80); D = 64; a ragged Lq and a k_lens inside the last key tile and
# under one tile; few queries and many keys.
F32_SHAPES = [(1, 257, 257, 16, 80, None), (2, 257, 257, 4, 64, None),
              (2, 130, 200, 3, 80, (200, 37)), (1, 40, 700, 2, 64, (650,)),
              (2, 77, 77, 2, 128, (77, 1))]


@pytest.fixture
def no_tf32():
    """The plain twin's fp32 matmuls in full fp32."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved


def _f32_qkv(gen, b, lq, lk, n, d):
    return [torch.randn(b, l, n, d, generator=gen, device="cuda")
            for l in (lq, lk, lk)]


@pytest.mark.parametrize("b,lq,lk,n,d,k_lens", F32_SHAPES)
def test_f32_kernel_matches_plain(cuda, no_tf32, b, lq, lk, n, d, k_lens):
    q, k, v = _f32_qkv(cuda, b, lq, lk, n, d)
    kl = _klens(k_lens)
    counts = tfa.launch_counts()
    got = tfa.flash_attention(q, k, v, kl)
    after = tfa.launch_counts()
    assert after["f32_launches"] == counts["f32_launches"] + 1
    assert after["launches"] == counts["launches"]
    _close(got, tfa.flash_attention_plain(q, k, v, kl), F32_REL_TOL)


def test_f32_kernel_reads_a_fused_qkv_buffer(cuda, no_tf32):
    """The CLIP's q, k and v: views of one [B, L, 3, N, D] to_qkv output,
    read through their strides."""
    qkv = torch.randn(1, 257, 3, 16, 80, generator=cuda, device="cuda")
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    _close(tfa.flash_attention(q, k, v),
           tfa.flash_attention_plain(q.contiguous(), k.contiguous(),
                                     v.contiguous()), F32_REL_TOL)


def test_f32_kernel_is_deterministic(cuda):
    q, k, v = _f32_qkv(cuda, 1, 257, 257, 16, 80)
    assert torch.equal(tfa.flash_attention_cuda(q, k, v),
                       tfa.flash_attention_cuda(q, k, v))


def test_f32_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 16, 2, 84, device="cuda")
    with pytest.raises(ValueError, match="D=84"):
        tfa.flash_attention(q, q, q)
    q = torch.zeros(1, 16, 2, 136, device="cuda")
    with pytest.raises(ValueError, match="D=136"):
        tfa.flash_attention(q, q, q)
    q = torch.zeros(1, 16, 2, 81, device="cuda")[..., :80]
    with pytest.raises(ValueError, match="multiples of 2"):
        tfa.flash_attention(q, q, q)
    q = torch.zeros(1, 16, 2, 80, device="cuda", requires_grad=True)
    with pytest.raises(NotImplementedError, match="no kernel differentiates"):
        tfa.flash_attention(q, q, q)
    with pytest.raises(NotImplementedError, match="no kernel differentiates"):
        attention(q, q, q, compute_dtype=torch.float32)


def test_bf16_kernel_at_the_image_cross_shape(cuda):
    """The i2v DiT's image cross-attention: 257 keys, so the last 128-key
    tile holds one real key and 127 zero-filled rows (B=2, 7,800 queries
    cut to 1,000 here, 8 heads)."""
    q, k, v = _qkv(cuda, 2, 1000, 257)
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v)
    assert tfa.flash_attention.launches == before + 1
    _close(got, tfa.flash_attention_plain(q, k, v))
    # the one key of the last tile is attended to: moving it moves the rows
    k2, v2 = k.clone(), v.clone()
    v2[:, 256] += 4.0
    k2[:, 256] = k[:, 0]
    moved = tfa.flash_attention(q, k2, v2)
    _close(moved, tfa.flash_attention_plain(q, k2, v2))
    assert float((moved.float() - got.float()).abs().max()) > 1e-2


# ------------------------------------------------------------- int8 GEMM

# (M, K, N): ragged row tiles, a K tail shorter than one 128-byte slice, an
# N tail shorter than one 128-column tile, a single row, ±127 everywhere
INT8_SHAPES = [(1000, 512, 384), (129, 80, 136), (1, 5120, 5120),
               (300, 13824, 256), (7, 48, 24)]


def _int8_operands(gen, m, k, n, extreme=False):
    lo, hi = (126, 128) if extreme else (-127, 128)
    xq = torch.randint(lo, hi, (m, k), generator=gen, device="cuda",
                       dtype=torch.int8)
    wq = torch.randint(lo, hi, (n, k), generator=gen, device="cuda",
                       dtype=torch.int8)
    sx = torch.rand(m, 1, generator=gen, device="cuda") * 0.05 + 1e-3
    sw = torch.rand(n, generator=gen, device="cuda") * 0.01 + 1e-4
    bias = torch.randn(n, generator=gen, device="cuda", dtype=torch.bfloat16)
    return xq, wq, sx, sw, bias


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", INT8_SHAPES)
def test_int8_gemm_kernel_equals_plain(cuda, m, k, n, out_dtype, with_bias):
    """Bit for bit: the int32 sum is exact and the epilogue rounds each
    fp32 operation on its own, as the plain version's eager ops do."""
    xq, wq, sx, sw, bias = _int8_operands(cuda, m, k, n)
    bias = bias if with_bias else None
    before = tig.int8_gemm_fused.launches
    got = tig.int8_gemm_fused(xq, wq, sx, sw, bias, out_dtype=out_dtype)
    assert tig.int8_gemm_fused.launches == before + 1
    want = tig.int8_gemm_plain(xq, wq, sx, sw, bias, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert torch.equal(got, want)


def test_int8_gemm_kernel_exact_where_fp32_sums_are_not(cuda):
    """K = 5120 of 127·127 products: the sum passes 2²⁴, which an fp32
    accumulation rounds; the kernel's int32 does not."""
    xq, wq, sx, sw, _ = _int8_operands(cuda, 64, 5120, 64, extreme=True)
    one_m, one_n = torch.ones_like(sx), torch.ones_like(sw)
    got = tig.int8_gemm_fused(xq, wq, one_m, one_n, out_dtype=torch.float32)
    exact = torch.matmul(xq.double(), wq.double().t())
    assert float(exact.abs().max()) > 2 ** 24
    assert torch.equal(got, exact.float())
    assert torch.equal(tig.int8_matmul(xq, wq).double(), exact)


def test_w8a8_linear_on_cuda_goes_through_the_kernel(cuda):
    lin = QuantLinear(256, 384, act8=True, device="cuda")
    lin.init_random(cuda)
    lin.bias.normal_(generator=cuda)
    x = torch.randn(2, 77, 256, generator=cuda, device="cuda",
                    dtype=torch.bfloat16)
    before = tig.launch_counts()
    got = lin(x, torch.bfloat16)
    after = tig.launch_counts()
    assert after["int8_gemm_launches"] == before["int8_gemm_launches"] + 1
    assert after["quantize_launches"] == before["quantize_launches"] + 1
    xq, sx = tq.quantize_activations_plain(x)
    want = tig.int8_gemm_plain(xq.reshape(-1, 256), lin.qweight, sx, lin.scale
                               ).reshape(2, 77, 384) + lin.bias
    assert torch.equal(got, want)


def test_int8_gemm_kernel_refuses_what_it_does_not_take(cuda):
    xq, wq, sx, sw, _ = _int8_operands(cuda, 16, 40, 24)
    with pytest.raises(ValueError, match="multiple of 16"):
        tig.int8_gemm_fused(xq, wq, sx, sw)
    xq, wq, sx, sw, _ = _int8_operands(cuda, 16, 48, 20)
    with pytest.raises(ValueError, match="multiple of 16"):
        tig.int8_gemm_fused(xq, wq, sx, sw)
    xq, wq, sx, sw, _ = _int8_operands(cuda, 16, 48, 24)
    with pytest.raises(TypeError, match="int8"):
        tig.int8_gemm_fused(xq.float(), wq, sx, sw)
    with pytest.raises(TypeError, match="out_dtype"):
        tig.int8_gemm_fused(xq, wq, sx, sw, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="not on"):
        tig.int8_gemm_fused(xq, wq.cpu(), sx, sw)
    with pytest.raises(ValueError, match="positive multiple of 16"):
        tig.int8_gemm_fused(xq[:, :0], wq[:, :0], sx, sw)


# The redesigned GEMM's edges: M around its 64-row warpgroup halves and
# 128-row tiles, N around its 256-column tiles (and one 8-column chunk), K
# under, at and past one 128-byte slice (TMA zero-fills the tail).
GEMM_M = [1, 63, 64, 65, 129, 333, 1024]
GEMM_N = [8, 136, 264, 5120]
GEMM_K = [16, 48, 144, 5120]
# (bias, bias_after_cast): none, fp32 before the cast, after the cast
BIAS_MODES = [(False, False), (True, False), (True, True)]


@pytest.mark.parametrize("n", GEMM_N)
@pytest.mark.parametrize("m", GEMM_M)
def test_int8_gemm_kernel_equals_plain_in_every_mode(cuda, m, n):
    """Bit for bit against the plain version at every K of ``GEMM_K``, in
    the three bias modes and both output types."""
    for k in GEMM_K:
        xq, wq, sx, sw, bias = _int8_operands(cuda, m, k, n)
        for out_dtype in (torch.bfloat16, torch.float32):
            for with_bias, after in BIAS_MODES:
                b = bias if with_bias else None
                got = tig.int8_gemm_fused(xq, wq, sx, sw, b, out_dtype,
                                          bias_after_cast=after)
                want = tig.int8_gemm_plain(xq, wq, sx, sw, b, out_dtype,
                                           bias_after_cast=after)
                assert got.dtype == out_dtype and got.shape == (m, n)
                assert torch.equal(got, want), (k, out_dtype, with_bias,
                                                after)


def test_int8_gemm_kernel_takes_unaligned_and_strided_inputs(cuda):
    """Operands that start off a 16-byte boundary or are views with
    strides: the wrapper hands the kernel aligned contiguous copies and
    the result is the plain version's on contiguous inputs."""
    m, k, n = 200, 272, 136
    xq, wq, sx, sw, bias = _int8_operands(cuda, m, k, n)
    raw = torch.empty(m * k + 1, dtype=torch.int8, device="cuda")
    xq_off = raw[1:].view(m, k)
    xq_off.copy_(xq)
    assert xq_off.data_ptr() % 16
    wq_t = wq.t().contiguous().t()                # [N, K] column-major view
    sx_s = torch.stack([sx[:, 0], sx[:, 0]], 1)[:, 0]  # stride 2
    assert not wq_t.is_contiguous() and not sx_s.is_contiguous()
    for after in (False, True):
        got = tig.int8_gemm_fused(xq_off, wq_t, sx_s, sw, bias,
                                  bias_after_cast=after)
        want = tig.int8_gemm_plain(xq, wq, sx, sw, bias,
                                   bias_after_cast=after)
        assert torch.equal(got, want)


# Shapes with enough output tiles for several rounds of the persistent
# grid, where the launch takes the wide (128 x 256) tiles; the shapes above
# take the narrow ones.
WIDE_SHAPES = [(4200, 144, 5120), (2000, 48, 13832), (4200, 5120, 5120)]


@pytest.mark.parametrize("m,k,n", WIDE_SHAPES)
def test_int8_gemm_kernel_wide_tiles_equal_plain(cuda, m, k, n):
    xq, wq, sx, sw, bias = _int8_operands(cuda, m, k, n)
    for out_dtype in (torch.bfloat16, torch.float32):
        for with_bias, after in BIAS_MODES:
            b = bias if with_bias else None
            got = tig.int8_gemm_fused(xq, wq, sx, sw, b, out_dtype,
                                      bias_after_cast=after)
            want = tig.int8_gemm_plain(xq, wq, sx, sw, b, out_dtype,
                                       bias_after_cast=after)
            assert torch.equal(got, want), (out_dtype, with_bias, after)


@pytest.mark.parametrize("m,k,n", [(3000, 1024, 2048), WIDE_SHAPES[0]])
def test_int8_gemm_kernel_is_deterministic(cuda, m, k, n):
    """Each tile sums its K slices in one order: the same bits from run
    to run, where the persistent grid walks several tiles per block."""
    xq, wq, sx, sw, bias = _int8_operands(cuda, m, k, n)
    first = tig.int8_gemm_fused(xq, wq, sx, sw, bias, bias_after_cast=True)
    for _ in range(3):
        assert torch.equal(first, tig.int8_gemm_fused(
            xq, wq, sx, sw, bias, bias_after_cast=True))


# ------------------------------------------------- activation quantization


def _hard_rows(gen, m, k, dtype):
    """Gaussian rows at random scales; every third row on exact .5 ties of
    x / sx (absmax 127·2^e makes sx = 2^e exactly), every fourth all zero,
    every fifth one spike in zeros."""
    x = torch.randn(m, k, generator=gen, device="cuda") * 2.0 ** torch.randint(
        -8, 8, (m, 1), generator=gen, device="cuda")
    step = 2.0 ** torch.randint(-6, 3, (m, 1), generator=gen, device="cuda")
    ties = (torch.randint(-126, 126, (m, k), generator=gen, device="cuda")
            + 0.5) * step
    ties[:, k // 2] = -127 * step[:, 0]
    spike = torch.zeros_like(x)
    spike[:, k // 3] = 50.0
    rows = torch.arange(m, device="cuda")[:, None]
    x = torch.where(rows % 3 == 0, ties, x)
    x = torch.where((rows % 4 == 0) & (rows % 3 != 0), 0.0, x)
    x = torch.where((rows % 5 == 0) & (rows % 3 != 0) & (rows % 4 != 0),
                    spike, x)
    return x.to(dtype)


@pytest.mark.parametrize("k", [16, 136, 5120, 13824, 32768])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_kernel_equals_plain(cuda, dtype, k):
    x = _hard_rows(cuda, 97, k, dtype)
    before = tq.quantize_activations.launches
    got_q, got_s = tq.quantize_activations(x)
    assert tq.quantize_activations.launches == before + 1
    want_q, want_s = tq.quantize_activations_plain(x)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert got_s.shape == (97, 1)
    assert torch.equal(got_q, want_q) and torch.equal(got_s, want_s)
    ties = (got_q[0].float() - x[0].float() / got_s[0]).abs() == 0.5
    assert bool(ties.sum() > k // 4)


def test_quantize_kernel_reads_views_and_propagates_nan(cuda):
    """A [B, L, K] view with strides is quantized as its contiguous copy;
    a NaN in a row makes that row's sx NaN, as amax does."""
    x = _hard_rows(cuda, 2 * 60, 2 * 256, torch.bfloat16).reshape(
        2, 60, 512)[..., 256:]
    assert not x.is_contiguous()
    got_q, got_s = tq.quantize_activations(x)
    want_q, want_s = tq.quantize_activations_plain(x.contiguous())
    assert got_q.shape == (2, 60, 256) and got_s.shape == (2, 60, 1)
    assert torch.equal(got_q, want_q) and torch.equal(got_s, want_s)
    y = x.contiguous()
    y[1, 7, 9] = float("nan")
    got_q, got_s = tq.quantize_activations(y)
    want_q, want_s = tq.quantize_activations_plain(y)
    assert bool(torch.isnan(got_s[1, 7]).all()) and bool(
        torch.isnan(want_s[1, 7]).all())
    keep = torch.ones(2, 60, dtype=torch.bool, device="cuda")
    keep[1, 7] = False
    assert torch.equal(got_q[keep], want_q[keep])
    assert torch.equal(got_s[keep], want_s[keep])


def test_quantize_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(4, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        tq.quantize_activations(x)
    with pytest.raises(ValueError, match="multiple of 8"):
        tq.quantize_activations(torch.zeros(4, 12, device="cuda"))
    with pytest.raises(ValueError, match="multiple of 8"):
        tq.quantize_activations(torch.zeros(4, 0, device="cuda"))
    with pytest.raises(ValueError, match="up to"):
        tq.quantize_activations(torch.zeros(1, 32776, device="cuda"))
    with pytest.raises(ValueError, match="is on cpu"):
        tq.quantize_activations_cuda(torch.zeros(4, 64))


# ------------------------------------------------ VAE encode, DiT parking


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.bfloat16, 5e-2)])
def test_vae_encode_streaming_equals_full_on_cuda(cuda, dtype, tol):
    """The streaming encode (first frame, then chunks of 4) against the
    full-tensor encode at the Wan VAE's width, on the card. fp32 with TF32
    off: the same convs over other frame groupings differ by fp32
    rounding, far under 1e-3 of the latents' scale. bf16: cuDNN may pick
    other algorithms for the chunk shapes, so bf16 roundings (2^-8) land
    differently over the ~25 layers; 5e-2 bounds that (the CPU test's
    bound against JAX). A lost or doubled cache frame is off by O(1)."""
    from moviigen_tpu_torch.configs import VAEConfig
    from moviigen_tpu_torch.models import vae as tvae
    from moviigen_tpu_torch.models.vae_streaming import encode_streaming

    cfg = VAEConfig()
    params = tvae.init_params(cfg, cuda, device="cuda", encoder=True)
    video = (torch.rand((1, 3, 9, 64, 96), generator=cuda, device="cuda")
             * 2 - 1).to(dtype)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            full = tvae.encode(params, video, cfg)
            stream = encode_streaming(params, video, cfg)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert full.shape == stream.shape == (1, cfg.z_dim, 3, 8, 12)
    assert full.dtype == stream.dtype == dtype
    scale = full.float().abs().max()
    assert (stream.float() - full.float()).abs().max() <= tol * scale


def test_pipeline_parks_the_dit_on_cuda(cuda, monkeypatch):
    """Over FREE_DIT_DECODE_GIB the DiT's weights leave the card for
    the decode and come back for the next request, which gives the video
    of a pipeline that never parked it."""
    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.pipelines import text2video as t2v

    def make():
        return t2v.WanT2V(WAN_CONFIGS["t2v-tiny"], device="cuda",
                          attn_backend="plain")

    kw = dict(size=(64, 64), frame_num=5, sampling_steps=2, seed=3)
    want = make().generate("a cat", **kw)
    pipe = make()
    shape, _, _ = t2v.compute_target_shape_and_seq_len(
        pipe.config, kw["size"], kw["frame_num"])
    gib = t2v.decode_gib(shape, pipe.config.vae)
    monkeypatch.setattr(t2v, "FREE_DIT_DECODE_GIB", gib * 0.99)
    pipe.generate("a dog", **kw)
    assert pipe.dit_parked
    assert all(p.device.type == "cpu" for p in pipe.dit.parameters())
    monkeypatch.setattr(t2v, "FREE_DIT_DECODE_GIB", gib)
    got = pipe.generate("a cat", **kw)
    assert not pipe.dit_parked and "dit_unpark_s" in pipe.timings
    assert all(p.device.type == "cuda" for p in pipe.dit.parameters())
    assert (got == want).all()


# ---------------------------------------------------------- LoRA on the card


def _lora_dit(gen, quant):
    """A 2-block DiT at head_dim 128 (what the kernels take) with a live
    head, its base frozen, and live adapters attached (B ≠ 0)."""
    from moviigen_tpu_torch.configs import WAN_CONFIGS
    from moviigen_tpu_torch.models.wan_model import WanModel
    from moviigen_tpu_torch.training import lora

    cfg = WAN_CONFIGS["t2v-tiny"].model.replace(dim=256, num_heads=2,
                                                ffn_dim=512)
    model = WanModel(cfg, dtype=torch.float32, device="cuda",
                     quant=quant).init_weights(gen)
    with torch.no_grad():
        model.head.weight.normal_(0.0, 0.1, generator=gen)
    model.requires_grad_(False)
    adapters = lora.init_lora_params(model, rank=8, generator=gen)
    with torch.no_grad():
        for ad in adapters.values():
            ad.B.normal_(0.0, 0.1, generator=gen)
    lora.attach_lora(model, adapters, alpha=16.0, rank=8)
    return cfg, model, adapters


@pytest.mark.parametrize("quant", [None, "int8"])
def test_lora_adapter_grads_on_cuda_match_plain(cuda, quant):
    """The adapters' gradients through the attention kernels (stats
    forward, dKV, dQ; per-block remat) against the plain attention, over
    a frozen fp32 or int8 QLoRA base: 3e-2 of each gradient's norm
    (chip_smoke.py's PARAM_GRAD_REL_TOL: bf16 rounding in attention,
    rounded again by every later bf16 product). Every adapter gets a
    gradient, the base none."""
    from moviigen_tpu_torch.ops.rope import rope_3d_freqs
    from moviigen_tpu_torch.training.lora import lora_parameters

    cfg, model, adapters = _lora_dit(cuda, quant)
    params = list(lora_parameters(adapters))
    x = torch.randn(1, cfg.in_dim, 3, 16, 16, generator=cuda, device="cuda")
    t = torch.full((1,), 500.0, device="cuda")
    ctx = torch.randn(1, cfg.text_len, cfg.text_dim, generator=cuda,
                      device="cuda")
    target = torch.randn(x.shape, generator=cuda, device="cuda")
    rope = rope_3d_freqs((3, 8, 8), cfg.head_dim, device="cuda")
    grads = {}
    for backend in ("auto", "plain"):
        tfa.reset_launch_counts()
        pred = model(x, t, ctx, rope, attn_backend=backend, remat=True)
        loss = torch.mean(torch.square(pred - target))
        grads[backend] = torch.autograd.grad(loss, params)
        counts = tfa.launch_counts()
        sites = 2 * cfg.num_layers
        assert counts == (dict(dict.fromkeys(tfa.COUNTERS, 0),
                               stats_launches=2 * sites,
                               dkv_launches=sites, dq_launches=sites)
                          if backend == "auto"
                          else dict.fromkeys(tfa.COUNTERS, 0))
    for g, w in zip(grads["auto"], grads["plain"]):
        assert bool(w.abs().max() > 0)
        assert float((g - w).norm() / w.norm()) <= 3e-2
    assert all(p.grad is None for p in model.parameters())


def test_w8a8_lora_side_path_on_cuda(cuda):
    """W8A8 linears with adapters on the card: ``_dense`` and the shared-
    input ``_dense_multi`` run the int8 GEMM and the activation
    quantization, then each output's side path; equal to the same steps
    through the plain int8 GEMM and quantization, bit for bit (the kernels
    are, and the side path is the same code)."""
    from moviigen_tpu_torch.models import wan_model as wm

    _, model, _ = _lora_dit(cuda, "w8a8")
    attn = model.blocks[0].self_attn
    x = torch.randn(2, 77, 256, generator=cuda, device="cuda",
                    dtype=torch.bfloat16)

    def plain(lin, xq, sx, after):
        out = tig.int8_gemm_plain(xq.reshape(-1, 256), lin.qweight,
                                  sx.reshape(-1), lin.scale, lin.bias,
                                  bias_after_cast=after).reshape(2, 77, -1)
        return lin.lora.side(x, out)

    xq, sx = tq.quantize_activations_plain(x)
    with torch.no_grad():
        tig.reset_launch_counts()
        got = wm._dense_multi([attn.q, attn.k, attn.v], x, torch.bfloat16)
        assert tig.launch_counts() == {"int8_gemm_launches": 3,
                                       "quantize_launches": 1}
        for lin, g in zip((attn.q, attn.k, attn.v), got):
            assert torch.equal(g, plain(lin, xq, sx, False))
        one = wm._dense(attn.o, x, torch.bfloat16)
        assert torch.equal(one, plain(attn.o, xq, sx, True))
        bare = attn.o.lora
        del attn.o.lora
        assert not torch.equal(wm._dense(attn.o, x, torch.bfloat16), one)
        attn.o.lora = bare
