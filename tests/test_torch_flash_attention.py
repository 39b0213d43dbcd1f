"""The port's flash attention against the JAX Pallas kernel.

On the CPU the port's wrapper runs its plain version; the Pallas kernel
runs in interpreter mode, as ``tests/test_flash_attention.py`` runs it.
The CUDA kernel itself is held against the plain version on the card in
``tests/test_torch_kernels_gpu.py``.
"""

import functools
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from moviigen_tpu.ops import flash_attention as jfa
from moviigen_tpu_torch.ops import flash_attention as tfa

_orig_pallas_call = pl.pallas_call


def _pallas_interp(q, k, v, k_lens=None, block=128):
    with mock.patch.object(jfa.pl, "pallas_call",
                           functools.partial(_orig_pallas_call,
                                             interpret=True)):
        out = jfa.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            k_lens=None if k_lens is None else jnp.asarray(k_lens, jnp.int32),
            block_q=block, block_k=block)
    return np.asarray(out.astype(jnp.float32))


def _qkv(b, lq, n, d, lk=None, seed=0):
    rng = np.random.default_rng(seed)
    lk = lk or lq
    return (rng.standard_normal((b, lq, n, d)).astype(np.float32),
            rng.standard_normal((b, lk, n, d)).astype(np.float32),
            rng.standard_normal((b, lk, n, d)).astype(np.float32))


# fp32: the tolerance of tests/test_flash_attention.py
@pytest.mark.parametrize("shape,lk,k_lens", [
    ((1, 128, 2, 32), None, None),
    ((2, 300, 3, 64), None, None),
    ((1, 1024, 1, 128), None, None),
    ((2, 200, 2, 64), 512, None),          # cross-attention: Lk != Lq
    ((2, 200, 2, 32), None, (200, 77)),    # ragged key tail per batch
])
def test_plain_matches_pallas_interpret_fp32(shape, lk, k_lens):
    q, k, v = _qkv(*shape, lk=lk, seed=sum(shape))
    want = _pallas_interp(q, k, v, k_lens)
    got = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        k_lens=None if k_lens is None else torch.tensor(k_lens))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)


def test_plain_matches_pallas_interpret_bf16():
    """bf16 inputs and output on both sides. Both round q·c, P and the
    output to bf16, but at different key blocks (512 against 128), so the
    rounding of P differs; outputs agree to a few bf16 steps (2^-8 of
    the value): atol 2e-2 on outputs of magnitude ~1."""
    q, k, v = _qkv(2, 300, 2, 64, seed=11)
    k_lens = (300, 131)
    bf = jnp.bfloat16
    want = _pallas_interp(jnp.asarray(q, bf), jnp.asarray(k, bf),
                          jnp.asarray(v, bf), k_lens)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = tfa.flash_attention(tq, tk, tv, k_lens=torch.tensor(k_lens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2,
                               rtol=2e-2)


def test_cpu_tensors_do_not_launch_the_kernel(monkeypatch):
    monkeypatch.setattr(tfa.flash_attention, "launches", 0)
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 64, 2, 128, seed=3))
    tfa.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert tfa.flash_attention.launches == 0


def test_kernel_refuses_cpu_tensors_and_unsupported_head_dim():
    q = torch.zeros(1, 16, 2, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not on"):
        tfa.flash_attention_cuda(q, q, q)
    q64 = torch.zeros(1, 16, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="D=64"):
        tfa.flash_attention_cuda(q64, q64, q64)

