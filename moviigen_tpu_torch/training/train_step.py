"""Flow-matching fine-tune step: loss, gradients, clip, AdamW.

Counterpart of ``moviigen_tpu/training/train_step.py`` (ref
``scripts/train/finetune.py::process_batch`` and the optimizer plumbing
of its ``main``):

    σ ~ schedule[density_sample(u)]
    noisy = σ·noise + (1−σ)·latents
    pred  = DiT(noisy, t=σ·T, context)
    loss  = mean((pred − (noise − latents))²)
    grads → clip by global norm → AdamW → params

The optimizer is the JAX package's optax chain written out, so that the
same gradients give the same parameters:

- ``optax.clip_by_global_norm``: g·(max/‖g‖) exactly when ‖g‖ ≥ max (not
  ``torch.nn.utils.clip_grad_norm_``'s max/(‖g‖ + 1e-6));
- ``optax.adamw``: m = (1−β₁)g + β₁m, v = (1−β₂)g² + β₂v, bias-corrected
  with the incremented count, u = m̂/(√v̂ + ε) + wd·p on every parameter
  (no mask: biases and norm scales decay too), p += −lr·u;
- the learning rate is the schedule at the count *before* the update, so
  with warmup the first update has lr 0;
- ``optax.MultiSteps`` (``grad_accum_steps`` = k): the running mean of k
  micro-batch gradients, one update per cycle; the logged grad_norm stays
  the raw micro-batch norm (train_step.py:192-196).

The state lives in fp32 beside each parameter and is updated in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..diffusion.flow_match import (compute_density_for_timestep_sampling,
                                    flow_match_noisy, flow_match_target,
                                    sigmas_for_timesteps, train_schedule)
from ..models.wan_model import WanModel
from ..ops.rope import RopeTables


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX ``TrainConfig``: the same fields and defaults."""

    learning_rate: float = 1e-6          # finetune.sh: lr 1e-6
    weight_decay: float = 1e-4           # finetune.py default
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    max_grad_norm: float = 1.0           # finetune.py:595
    weighting_scheme: str = "uniform"    # uniform | logit_normal | mode
    logit_mean: float = 0.0
    logit_std: float = 1.0
    mode_scale: float = 1.29
    num_train_timesteps: int = 1000
    schedule_shift: float = 1.0
    remat: bool = True
    residual_dtype: str = "float32"      # or "bfloat16" (the reference's autocast)
    remat_group: int = 1
    grad_accum_steps: int = 1            # finetune.py:535-597 accumulation cycle
    compute_ot: bool = False             # OT noise pairing (finetune.py:206-208)
    lr_warmup_steps: int = 0
    lr_scheduler: str = "constant"       # constant | linear | cosine
    max_train_steps: int = 100


def _linear(init: float, end: float, steps: int, n: int) -> float:
    """``optax.linear_schedule(init, end, steps)`` at count n."""
    frac = 1.0 - min(max(n, 0), steps) / steps
    return (init - end) * frac + end


def lr_schedule(tc: TrainConfig) -> Callable[[int], float]:
    """The learning rate at update count n (0 for the first update), as
    the JAX ``make_optimizer``'s optax schedules give it."""
    lr = tc.learning_rate
    if tc.lr_scheduler == "constant":
        warm = max(tc.lr_warmup_steps, 1)
        if tc.lr_warmup_steps <= 0:
            return lambda n: lr
        return lambda n: _linear(0.0, lr, warm, n) if n < warm else lr
    if tc.lr_scheduler == "linear":
        return lambda n: _linear(lr, 0.0, tc.max_train_steps, n)
    if tc.lr_scheduler == "cosine":
        steps = tc.max_train_steps
        return lambda n: lr * (0.5 * (1.0 + math.cos(
            math.pi * min(n, steps) / steps)))
    raise ValueError(f"lr_scheduler {tc.lr_scheduler!r} not in "
                     "('constant', 'linear', 'cosine')")


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """√(Σ x²) over every element of every tensor, fp32 (optax
    ``global_norm``)."""
    total = None
    for x in tensors:
        s = torch.sum(torch.square(x.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def _f32(x: float) -> float:
    """``x`` rounded to fp32, as a jnp weak-typed scalar becomes."""
    return float(np.float32(x))


class AdamW:
    """``optax.chain(clip_by_global_norm, adamw)``, wrapped in
    ``MultiSteps`` when ``tc.grad_accum_steps`` > 1, over a list of
    parameters (updated in place)."""

    def __init__(self, params: Sequence[torch.Tensor], tc: TrainConfig):
        self.params: List[torch.Tensor] = list(params)
        self.tc = tc
        self.lr = lr_schedule(tc)
        self.count = 0      # updates applied (the adam and schedule count)
        self.mini_step = 0  # micro-batches accumulated in this cycle
        f32 = dict(dtype=torch.float32)
        self.m = [torch.zeros_like(p, **f32) for p in self.params]
        self.v = [torch.zeros_like(p, **f32) for p in self.params]
        self.acc = ([torch.zeros_like(p, **f32) for p in self.params]
                    if tc.grad_accum_steps > 1 else None)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor],
             norm: Optional[torch.Tensor] = None) -> bool:
        """Take one micro-batch's gradients; returns whether the
        parameters were updated. ``norm`` is ``global_norm(grads)`` if the
        caller has it (used when no accumulation intervenes)."""
        k = self.tc.grad_accum_steps
        if k > 1:
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.copy_(a + (g.float() - a) / (n + 1))
            self.mini_step = (n + 1) % k
            if n != k - 1:
                return False
            self._update(self.acc, None)
            for a in self.acc:
                a.zero_()
            return True
        self._update(grads, norm)
        return True

    def _update(self, grads, norm):
        tc = self.tc
        b1, b2 = tc.betas
        if norm is None:
            norm = global_norm(grads)
        clip = not bool(norm < tc.max_grad_norm)
        lr = _f32(self.lr(self.count))
        self.count += 1
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(self.count))
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            g = g.float()
            if clip:
                g = g / norm * tc.max_grad_norm
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g * g * (1 - b2))
            u = (m / bc1) / (torch.sqrt(v / bc2) + tc.eps)
            u.add_(p.float() * tc.weight_decay)
            p.copy_(p.float() + u * -lr)

    def state_dict(self) -> Dict[str, object]:
        return {"count": self.count, "mini_step": self.mini_step,
                "m": self.m, "v": self.v, "acc": self.acc}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, object]) -> None:
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        for name in ("m", "v", "acc"):
            mine, theirs = getattr(self, name), state[name]
            if (mine is None) != (theirs is None) or (
                    mine is not None and len(mine) != len(theirs)):
                raise ValueError(f"optimizer state {name!r} does not match "
                                 "this optimizer's parameters")
            for a, b in zip(mine or (), theirs or ()):
                a.copy_(b)


def make_optimizer(params: Sequence[torch.Tensor], tc: TrainConfig) -> AdamW:
    return AdamW(params, tc)


def make_train_step(model: WanModel, tc: TrainConfig, rope: RopeTables,
                    optimizer: AdamW, seq_len: Optional[int] = None,
                    attn_backend: str = "auto",
                    compute_dtype: torch.dtype = torch.bfloat16,
                    generator: Optional[torch.Generator] = None):
    """Returns ``step(batch, noise=None, u=None) → metrics``: one
    micro-batch through loss, gradients and ``optimizer`` (which updates
    ``model`` in place). ``batch`` holds ``latents`` [B, C, F, H, W] and
    ``context`` [B, text_len, text_dim]; noise and the density draw u come
    from ``generator`` unless given (the tests hand in JAX's draws).
    Metrics: ``loss``, ``grad_norm`` (raw micro-batch norm) and
    ``timestep_mean``, as 0-dim tensors."""
    if tc.compute_ot:
        raise NotImplementedError(
            "compute_ot (optimal-transport noise pairing) comes with the "
            "LoRA/OT part of ROADMAP queue 1 item 8")
    sigmas_tab = train_schedule(tc.num_train_timesteps, tc.schedule_shift)[0]
    rdt = getattr(torch, tc.residual_dtype)
    params = optimizer.params

    def step(batch, noise=None, u=None):
        latents, context = batch["latents"], batch["context"]
        if noise is None or u is None:
            if generator is None:
                raise ValueError("make_train_step: pass a generator, or "
                                 "both noise and u")
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator,
                                device=latents.device, dtype=torch.float32)
        if u is None:
            u = compute_density_for_timestep_sampling(
                generator, tc.weighting_scheme, latents.shape[0],
                tc.logit_mean, tc.logit_std, tc.mode_scale)
        sigmas = sigmas_for_timesteps(u.to(latents.device), sigmas_tab,
                                      tc.num_train_timesteps)
        noisy = flow_match_noisy(latents, noise, sigmas)
        t = sigmas * tc.num_train_timesteps
        pred = model(noisy, t, context, rope, seq_len=seq_len,
                     compute_dtype=compute_dtype, attn_backend=attn_backend,
                     residual_dtype=rdt, remat=tc.remat,
                     remat_group=tc.remat_group)
        target = flow_match_target(latents, noise)
        loss = torch.mean(torch.square(pred.float() - target.float()))
        grads = torch.autograd.grad(loss, params)
        gnorm = global_norm(grads)
        optimizer.step(grads, gnorm)
        return {"loss": loss.detach(), "grad_norm": gnorm,
                "timestep_mean": t.mean()}

    return step
