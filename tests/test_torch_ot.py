"""The port's optimal-transport noise pairing (``training/ot.py``) against
``moviigen_tpu.training.ot``, and the train step with ``compute_ot``
against the JAX ``make_train_step`` with JAX's draws replayed."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from moviigen_tpu.training import ot as jot
from moviigen_tpu.training import train_step as jts
from moviigen_tpu.ops.rope import rope_3d_freqs as jax_rope
from moviigen_tpu_torch.ops.rope import rope_3d_freqs
from moviigen_tpu_torch.training import (TrainConfig, make_optimizer,
                                         make_train_step)
from moviigen_tpu_torch.training import ot as tot

from test_torch_training import (CFG, GRID, JCFG, jax_draws,
                                 jax_params_live_head, make_batch,
                                 port_model)

SIZES = (1, 2, 5, 8, 9, 12)  # brute force up to 8, scipy above


def _pair(n, seed=0):
    rng = np.random.default_rng(seed + n)
    x = rng.standard_normal((n, 4, 2, 3, 3)).astype(np.float32)
    y = rng.standard_normal((n, 4, 2, 3, 3)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("n", SIZES)
def test_cosine_cost_matches_jax(n):
    """fp32 at full precision on both sides (HIGHEST in JAX): 1e-6."""
    x, y = _pair(n)
    want = np.asarray(jot.cosine_cost(jnp.asarray(x), jnp.asarray(y)))
    got = tot.cosine_cost(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32 and got.shape == (n, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n", SIZES)
def test_linear_assignment_matches_jax(n):
    """The same permutation as JAX on the same cost matrix (exactly), and
    the optimum: its total equals scipy's."""
    x, y = _pair(n)
    cost = np.asarray(jot.cosine_cost(jnp.asarray(x), jnp.asarray(y)))
    want = np.asarray(jot.linear_assignment(jnp.asarray(cost)))
    got = tot.linear_assignment(torch.from_numpy(cost))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    rows, cols = linear_sum_assignment(cost)
    assert cost[np.arange(n), got.numpy()].sum() == pytest.approx(
        cost[rows, cols].sum(), abs=1e-6)


@pytest.mark.parametrize("n", SIZES)
def test_linear_assignment_ties_match_jax(n):
    """Ties: an all-equal cost matrix, and one whose rows repeat in pairs.
    Up to 8 both sides take the first minimum over the permutations in
    ``itertools`` order (``argmin``); above, both ask scipy."""
    rng = np.random.default_rng(n)
    flat = np.zeros((n, n), np.float32)
    half = rng.standard_normal(((n + 1) // 2, n)).astype(np.float32)
    paired = np.repeat(half, 2, axis=0)[:n]
    for cost in (flat, paired):
        want = np.asarray(jot.linear_assignment(jnp.asarray(cost)))
        got = tot.linear_assignment(torch.from_numpy(cost)).numpy()
        np.testing.assert_array_equal(got, want)
        if n <= tot.BRUTE_FORCE_MAX:
            totals = [cost[np.arange(n), p].sum()
                      for p in itertools.permutations(range(n))]
            first = list(itertools.permutations(range(n)))[
                int(np.argmin(totals))]
            np.testing.assert_array_equal(got, first)
    np.testing.assert_array_equal(
        tot.linear_assignment(torch.from_numpy(flat)).numpy(), np.arange(n))


@pytest.mark.parametrize("n", [1, 4, 10])
def test_ot_pair_noise_matches_jax(n):
    """The paired noise equals JAX's bit for bit (a permutation of the
    same rows); a batch of one comes back as it was."""
    x, y = _pair(n, seed=3)
    want = np.asarray(jot.ot_pair_noise(jnp.asarray(x), jnp.asarray(y)))
    noise = torch.from_numpy(y)
    got = tot.ot_pair_noise(torch.from_numpy(x), noise)
    np.testing.assert_array_equal(got.numpy(), want)
    if n == 1:
        assert got is noise
    else:
        _, col = tot.cosine_optimal_transport(torch.from_numpy(x), noise)
        assert sorted(col.tolist()) == list(range(n))


def test_train_step_with_ot_matches_jax():
    """``compute_ot`` in the train step: the noise is drawn, paired to the
    latents and then the density is drawn (train_step.py:173-191). Given
    JAX's raw draws, the port pairs them itself and lands on JAX's loss
    within 1e-3 (bf16 compute; measured 1.5e-7) and its grad norm within
    2e-2 (as test_torch_training.py::test_train_step_matches_jax). The
    pairing is not the identity here: without OT the loss is 2.2e-3 off."""
    params = jax_params_live_head()
    latents, context = make_batch(b=4, seed=9)
    key = jax.random.PRNGKey(2)
    jtc = jts.TrainConfig(compute_ot=True, remat=False)
    step = jts.make_train_step(JCFG, jtc, jax_rope(GRID, JCFG.head_dim),
                               attn_backend="xla")
    _, opt_state = jts.init_train_state(params, jtc)
    _, _, jm = jax.jit(step)(params, opt_state,
                             {"latents": jnp.asarray(latents),
                              "context": jnp.asarray(context)}, key)
    noise, u = jax_draws(key, latents.shape, jtc)
    _, col = tot.cosine_optimal_transport(torch.from_numpy(latents), noise)
    assert col.tolist() != list(range(4))

    losses = {}
    for ot in (True, False):
        tc = TrainConfig(compute_ot=ot, remat=False)
        model = port_model(params)
        tstep = make_train_step(model, tc, rope_3d_freqs(GRID, CFG.head_dim),
                                make_optimizer(list(model.parameters()), tc))
        tm = tstep({"latents": torch.from_numpy(latents),
                    "context": torch.from_numpy(context)}, noise=noise, u=u)
        losses[ot] = float(tm["loss"])
        if ot:
            assert float(tm["grad_norm"]) == pytest.approx(
                float(jm["grad_norm"]), rel=2e-2)
    assert losses[True] == pytest.approx(float(jm["loss"]), rel=1e-3)
    assert losses[False] != pytest.approx(float(jm["loss"]), rel=1e-3)
