"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``gpu`` and skips without a CUDA device.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed; there, skip the suite's JAX conftest:

    python -m pytest --noconftest -q tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

from moviigen_tpu_torch.ops import flash_attention as tfa

pytestmark = pytest.mark.gpu

# chip_smoke.py's tolerance: 1e-2 of the output's largest magnitude (bf16
# output rounding on both sides, P rounded at different key blocks)
REL_TOL = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _check(got, want):
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    err = float((got.float() - want.float()).abs().max())
    assert err <= REL_TOL * float(want.float().abs().max())


@pytest.mark.parametrize("b,lq,lk,k_lens", [
    (2, 1000, 1000, None),            # ragged q and k tiles
    (2, 777, 512, None),              # cross-attention shape
    (2, 1000, 1000, (1000, 600)),     # per-batch key mask
    (1, 64, 1, None),                 # a single key
])
def test_flash_kernel_matches_plain(cuda, b, lq, lk, k_lens):
    q, k, v = (torch.randn(b, l, 8, 128, generator=cuda, device="cuda",
                           dtype=torch.bfloat16) for l in (lq, lk, lk))
    kl = None if k_lens is None else torch.tensor(k_lens, device="cuda")
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, kl)
    assert tfa.flash_attention.launches == before + 1
    _check(got, tfa.flash_attention_plain(q, k, v, kl))


def test_flash_kernel_reads_strided_views(cuda):
    """q/k/v as views into wider tensors (the kernel reads [B, L, N, D]
    through its strides, no copies)."""
    qkv = torch.randn(2, 300, 3, 4, 128, generator=cuda, device="cuda",
                      dtype=torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    _check(tfa.flash_attention(q, k, v),
           tfa.flash_attention_plain(q.contiguous(), k.contiguous(),
                                     v.contiguous()))


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 16, 2, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="D=64"):
        tfa.flash_attention(q, q, q)
    q = torch.zeros(1, 16, 2, 128, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16"):
        tfa.flash_attention(q, q, q)
