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


@pytest.mark.parametrize("b,lq,lk,k_lens", SHAPES)
def test_flash_kernel_matches_plain(cuda, b, lq, lk, k_lens):
    q, k, v = _qkv(cuda, b, lq, lk)
    kl = _klens(k_lens)
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, kl)
    assert tfa.flash_attention.launches == before + 1
    _close(got, tfa.flash_attention_plain(q, k, v, kl))


@pytest.mark.parametrize("b,lq,lk,k_lens", SHAPES)
def test_stats_kernel_matches_plain(cuda, b, lq, lk, k_lens):
    q, k, v = _qkv(cuda, b, lq, lk)
    kl = _klens(k_lens)
    before = tfa.flash_attention.stats_launches
    got = tfa.flash_attention_stats_cuda(q, k, v, kl)
    assert tfa.flash_attention.stats_launches == before + 1
    want = tfa.flash_attention_stats_plain(q, k, v, kl)
    for g, w in zip(got, want):
        _close(g, w)


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
    before = tig.int8_gemm_fused.launches
    got = lin(x, torch.bfloat16)
    assert tig.int8_gemm_fused.launches == before + 1
    xq, sx = tig.quantize_activations(x)
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
