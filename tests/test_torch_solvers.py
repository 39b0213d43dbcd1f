"""The port's UniPC and DPM++ samplers against the JAX package's: the same
model-output sequence goes through both step functions, compared at every
step (fp32; the coefficient tables are the same float64 numpy on both
sides)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moviigen_tpu.diffusion import solvers as js
from moviigen_tpu_torch.diffusion import solvers as ts


def _pair(kind, steps, shift):
    if kind == "unipc":
        j = js.FlowUniPCMultistepScheduler(shift=1.0)
        t = ts.FlowUniPCMultistepScheduler(shift=1.0)
        j.set_timesteps(steps, shift=shift)
        t.set_timesteps(steps, shift=shift)
    else:
        j = js.FlowDPMSolverMultistepScheduler(shift=1.0)
        t = ts.FlowDPMSolverMultistepScheduler(shift=1.0)
        sig = js.get_sampling_sigmas(steps, shift)
        np.testing.assert_array_equal(ts.get_sampling_sigmas(steps, shift),
                                      sig)
        j.set_timesteps(steps, sigmas=sig)
        t.set_timesteps(steps, sigmas=sig)
    return j, t


@pytest.mark.parametrize("kind,steps,shift", [
    ("unipc", 2, 5.0), ("unipc", 7, 5.0), ("unipc", 20, 3.0),
    ("dpm++", 2, 5.0), ("dpm++", 7, 5.0), ("dpm++", 20, 3.0),
])
def test_step_sequence(kind, steps, shift):
    j, t = _pair(kind, steps, shift)
    np.testing.assert_array_equal(t.sigmas, j.sigmas)
    np.testing.assert_array_equal(t.timesteps, j.timesteps)
    rng = np.random.default_rng(steps)
    x0 = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    jx, tx = jnp.asarray(x0), torch.from_numpy(x0)
    jst, tst = j.init_state(jx), t.init_state(tx)
    for i in range(steps):
        v = rng.standard_normal(x0.shape).astype(np.float32)
        jx, jst = j.step(jnp.asarray(v), i, jx, jst)
        tx, tst = t.step(torch.from_numpy(v), i, tx, tst)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5,
                                   rtol=1e-5, err_msg=f"{kind} step {i}")


@pytest.mark.parametrize("steps,extra,strength", [
    (10, False, 1.0), (7, True, 1.0), (12, False, 0.6)])
def test_flow_match_scheduler_matches_jax(steps, extra, strength):
    """The training scheduler: its tables, Euler step, add_noise, target
    and training weights equal the JAX package's."""
    j = js.FlowMatchScheduler(num_inference_steps=steps, shift=5.0,
                              extra_one_step=extra)
    t = ts.FlowMatchScheduler(num_inference_steps=steps, shift=5.0,
                              extra_one_step=extra)
    for s in (j, t):
        s.set_timesteps(steps, denoising_strength=strength, training=True)
    np.testing.assert_array_equal(t.sigmas, j.sigmas)
    np.testing.assert_array_equal(t.timesteps, j.timesteps)
    np.testing.assert_array_equal(t.linear_timesteps_weights,
                                  j.linear_timesteps_weights)
    rng = np.random.default_rng(steps)
    x, v, n = (rng.standard_normal((2, 3, 4)).astype(np.float32)
               for _ in range(3))
    for ts_ in (j.timesteps[0], j.timesteps[steps // 2], j.timesteps[-1]):
        for final in (False, True):
            np.testing.assert_allclose(
                t.step(torch.from_numpy(v), ts_, torch.from_numpy(x),
                       to_final=final).numpy(),
                np.asarray(j.step(jnp.asarray(v), ts_, jnp.asarray(x),
                                  to_final=final)), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            t.add_noise(torch.from_numpy(x), torch.from_numpy(n),
                        ts_).numpy(),
            np.asarray(j.add_noise(jnp.asarray(x), jnp.asarray(n), ts_)),
            rtol=1e-6, atol=1e-7)
        np.testing.assert_equal(t.training_weight(ts_),
                                j.training_weight(ts_))  # NaN as JAX
    np.testing.assert_array_equal(
        t.training_target(torch.from_numpy(x), torch.from_numpy(n),
                          0).numpy(), n - x)
