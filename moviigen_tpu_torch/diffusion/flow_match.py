"""Flow-matching training utilities.

Counterpart of ``moviigen_tpu/diffusion/flow_match.py`` (ref
``scripts/train/finetune.py:122-157`` and ``process_batch``):

    noisy = σ·noise + (1−σ)·latents
    target = noise − latents
    loss = mean((pred − target)²)

The training noise schedule is the diffusers
FlowMatchEulerDiscreteScheduler: sigmas = linspace(1, 1/T, T) shifted,
timesteps = σ·T. Random draws come from an explicit ``torch.Generator``;
they cannot reproduce ``jax.random``'s numbers, so the tests hand both
packages the same draws.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .solvers import shift_sigmas


def train_schedule(num_train_timesteps: int = 1000,
                   shift: float = 1.0) -> tuple:
    """Training sigmas and timesteps (fp32 numpy): sigmas descend from 1
    to 1/T, timesteps = σ·T."""
    sigmas = np.linspace(1.0, 1.0 / num_train_timesteps,
                         num_train_timesteps, dtype=np.float64)
    sigmas = shift_sigmas(sigmas, shift)
    timesteps = sigmas * num_train_timesteps
    return sigmas.astype(np.float32), timesteps.astype(np.float32)


def compute_density_for_timestep_sampling(
        generator: torch.Generator, weighting_scheme: str, batch_size: int,
        logit_mean: Optional[float] = None,
        logit_std: Optional[float] = None,
        mode_scale: Optional[float] = None) -> torch.Tensor:
    """u ∈ [0, 1) density draw, fp32 [batch_size] on the generator's
    device (ref finetune.py:134-157)."""
    kw = dict(generator=generator, device=generator.device,
              dtype=torch.float32)
    if weighting_scheme == "logit_normal":
        u = logit_mean + logit_std * torch.randn(batch_size, **kw)
        return torch.sigmoid(u)
    u = torch.rand(batch_size, **kw)
    if weighting_scheme == "mode":
        u = 1 - u - mode_scale * (torch.cos(math.pi * u / 2) ** 2 - 1 + u)
    return u


def sigmas_for_timesteps(u: torch.Tensor, sigmas,
                         num_train_timesteps: int = 1000) -> torch.Tensor:
    """Density draws u → schedule index → σ (ref finetune.py:218-233:
    net effect ``σ = sigmas[int(u·T)]``)."""
    idx = torch.clamp((u * num_train_timesteps).to(torch.int64), 0,
                      num_train_timesteps - 1)
    return torch.as_tensor(sigmas, device=u.device)[idx]


def flow_match_noisy(latents: torch.Tensor, noise: torch.Tensor,
                     sigmas: torch.Tensor) -> torch.Tensor:
    """noisy = σ·noise + (1−σ)·x   (ref finetune.py:235)."""
    sigmas = sigmas.reshape(-1, *([1] * (latents.dim() - 1)))
    return sigmas * noise + (1.0 - sigmas) * latents


def flow_match_target(latents: torch.Tensor,
                      noise: torch.Tensor) -> torch.Tensor:
    """target = noise − x   (ref finetune.py:256)."""
    return noise - latents
