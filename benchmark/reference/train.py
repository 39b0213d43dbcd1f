"""The fine-tune step in plain float32 PyTorch, as Wan's fine-tune script
(``scripts/train/finetune.py`` of the MoviiGen trainer) takes it:

    u ~ U[0, 1);  σ = schedule[int(u·T)]  (schedule: linspace(1, 1/T, T))
    noisy = σ·noise + (1 − σ)·x;  pred = DiT(noisy, σ·T, text)
    loss = mean((pred − (noise − x))²)
    g → g · max/‖g‖ where ‖g‖ ≥ max → AdamW (bias-corrected, decoupled
    decay on every leaf) → p

The noise and u are drawn as the step under test draws them: ``randn``
of the latents' shape, then ``rand`` of the batch, from one generator on
the device seeded with the generator seed the harness gave the program.
The DiT is ``dit.py`` with every block and every head's block of queries
recomputed in the backward.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from . import dit as ref_dit
from .weights import dit_init, dit_specs, draw_all


def train_schedule(train_steps: int) -> np.ndarray:
    return np.linspace(1.0, 1.0 / train_steps, train_steps).astype(
        np.float32)


def leaves(seed: int, m: dict, device) -> Dict[str, torch.Tensor]:
    """The full fine-tune's fp32 leaves drawn from the seed."""
    out = {}
    for group in draw_all(seed, "dit", dit_specs(m, "float32"), dit_init(m),
                          device):
        out.update(group)
    return out


def run(seed: int, m: dict, hp: dict, batches: Sequence[dict],
        gen_seed: int, device, fp8: bool = False) -> dict:
    """Take ``len(batches)`` steps from the drawn weights. ``batches``:
    dicts of ``latents`` [B, C, F, H, W] and ``context`` [B, Lt, D] (the
    padded text zeroed), fp32 on ``device``. Returns the losses, the
    clipped gradient norms, every leaf's first gradient norm
    (``grad1``), each leaf's change after the last step (``change``) and
    the medians the comparison scales by."""
    p = {k: v.requires_grad_(True) for k, v in leaves(seed, m, device).items()}
    names = sorted(p)
    p0 = {k: v.detach().clone() for k, v in p.items()}
    mom = {k: torch.zeros_like(v) for k, v in p.items()}
    vel = {k: torch.zeros_like(v) for k, v in p.items()}
    gen = torch.Generator(device=device).manual_seed(gen_seed)
    T = hp["num_train_timesteps"]
    tab = torch.as_tensor(train_schedule(T), device=device)
    b1, b2 = hp["betas"]
    losses, norms, grad1 = [], [], {}
    ctx = ref_dit.Model(lambda group: p, m, fp8=fp8, remat=True)
    for step, batch in enumerate(batches, start=1):
        x, text = batch["latents"], batch["context"]
        noise = torch.randn(x.shape, generator=gen, device=device,
                            dtype=torch.float32)
        u = torch.rand(x.shape[0], generator=gen, device=device,
                       dtype=torch.float32)
        sig = tab[torch.clamp((u * T).long(), 0, T - 1)]
        s = sig.view(-1, 1, 1, 1, 1)
        noisy = s * noise + (1.0 - s) * x
        pred = ref_dit.forward(ctx, noisy, sig * T, text)
        loss = torch.mean((pred - (noise - x)).square())
        grads = torch.autograd.grad(loss, [p[k] for k in names])
        with torch.no_grad():
            norm = torch.sqrt(sum(g.double().square().sum() for g in grads))
            scale = (hp["max_grad_norm"] / norm).float() \
                if norm >= hp["max_grad_norm"] else 1.0
            lr = hp["learning_rate"]
            for k, g in zip(names, grads):
                g = g * scale
                mom[k].mul_(b1).add_(g * (1 - b1))
                vel[k].mul_(b2).add_(g * g * (1 - b2))
                mh = mom[k] / (1 - b1 ** step)
                vh = vel[k] / (1 - b2 ** step)
                upd = mh / (vh.sqrt() + hp["eps"]) \
                    + hp["weight_decay"] * p[k]
                p[k].sub_(lr * upd)
                if step == 1:
                    grad1[k] = float((mom[k] / (1 - b1)).double().norm())
        losses.append(float(loss.detach()))
        norms.append(float(norm))
        del grads, pred, loss
    change = {k: float((p[k].detach() - p0[k]).double().norm())
              for k in names}
    return {"loss": losses, "grad_norm": norms, "grad1": grad1,
            "change": change}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: List[str]) -> Dict[str, float]:
    """Per leaf the gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    med = float(np.median([ref[k] for k in keep]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in keep}


def moved_leaves(grad1: Dict[str, float]) -> List[str]:
    """The leaves whose first gradient in the reference is at least a
    thousandth of the median leaf's: the others move by round-off alone
    under Adam."""
    med = float(np.median(list(grad1.values())))
    return sorted(k for k, g in grad1.items() if g >= 1e-3 * med)


def worst(gaps: Dict[str, float]):
    k = max(gaps, key=gaps.get)
    return gaps[k], k
