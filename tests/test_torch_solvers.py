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
