"""UniPC for flow matching, as Wan2.1 samples with it
(``wan/utils/fm_solvers_unipc.py``, after diffusers'
``UniPCMultistepScheduler``): data prediction (x0 = x − σ·v), the bh2
variant, solver order 2 with a lower order on the first and last steps, a
corrector on every step after the first. Written step by step as the
published scheduler runs, with its host scalars in float64 and the
tensors in float32.
"""

from __future__ import annotations

import numpy as np
import torch


def sigmas(steps: int, shift: float, train_steps: int = 1000) -> np.ndarray:
    """The sampling sigmas and a final 0 (float64)."""
    alphas = np.linspace(1, 1 / train_steps, train_steps)[::-1]
    base = 1.0 - alphas
    sig = np.linspace(base[0], base[-1], steps + 1)[:-1]
    sig = shift * sig / (1 + (shift - 1) * sig)
    return np.concatenate([sig, [0.0]])


def timesteps(steps: int, shift: float, train_steps: int = 1000):
    """The timesteps the model is called with: int(σ·T)."""
    return (sigmas(steps, shift, train_steps)[:-1]
            * train_steps).astype(np.int64)


def _lam(s):
    with np.errstate(divide="ignore"):
        return np.log(1.0 - s) - np.log(s)


def _rhos(rks, hh, order, last: bool):
    """Solve R·ρ = b of the bh2 update (ρ over rks[:-1] for the
    predictor, over all for the corrector)."""
    h_phi_1 = np.expm1(hh)
    b_h = np.expm1(hh)
    h_phi_k = h_phi_1 / hh - 1
    fact, R, b = 1, [], []
    for i in range(1, order + 1):
        R.append(np.power(rks, i - 1))
        b.append(h_phi_k * fact / b_h)
        fact *= i + 1
        h_phi_k = h_phi_k / hh - 1 / fact
    R, b = np.stack(R), np.asarray(b)
    if last:
        return np.linalg.solve(R, b)
    return np.linalg.solve(R[:-1, :-1], b[:-1])


class UniPC:
    def __init__(self, steps: int, shift: float, order: int = 2):
        self.sig = sigmas(steps, shift)
        self.lam = _lam(self.sig)
        self.steps, self.order = steps, order
        self.outputs = []       # converted model outputs, oldest first
        self.last_sample = None
        self.lower_order_nums = 0
        self.this_order = 1

    def _predict(self, i, x, order):
        sig, lam = self.sig, self.lam
        m0 = self.outputs[-1]
        s_t, s_0 = sig[i + 1], sig[i]
        a_t = 1.0 - s_t
        h = lam[i + 1] - lam[i]
        hh = -h
        h_phi_1 = np.expm1(hh)
        b_h = np.expm1(hh)
        x_t = float(s_t / s_0) * x - float(a_t * h_phi_1) * m0
        if order > 1:
            rks, d1s = [], []
            for k in range(1, order):
                mk = self.outputs[-(k + 1)]
                rk = (lam[i - k] - lam[i]) / h
                rks.append(rk)
                d1s.append((mk - m0) / float(rk))
            rks.append(1.0)
            rho = ([0.5] if order == 2
                   else _rhos(np.asarray(rks), hh, order, last=False))
            res = sum(float(r) * d for r, d in zip(rho, d1s))
            x_t = x_t - float(a_t * b_h) * res
        return x_t

    def _correct(self, i, m_t, x_last, order):
        sig, lam = self.sig, self.lam
        m0 = self.outputs[-1]
        s_t, s_0 = sig[i], sig[i - 1]
        a_t = 1.0 - s_t
        h = lam[i] - lam[i - 1]
        hh = -h
        h_phi_1 = np.expm1(hh)
        b_h = np.expm1(hh)
        rks, d1s = [], []
        for k in range(1, order):
            mk = self.outputs[-(k + 1)]
            rk = (lam[i - 1 - k] - lam[i - 1]) / h
            rks.append(rk)
            d1s.append((mk - m0) / float(rk))
        rks.append(1.0)
        rho = ([0.5] if order == 1
               else _rhos(np.asarray(rks), hh, order, last=True))
        x_t = float(s_t / s_0) * x_last - float(a_t * h_phi_1) * m0
        res = sum(float(r) * d for r, d in zip(rho[:-1], d1s))
        return x_t - float(a_t * b_h) * (res + float(rho[-1]) * (m_t - m0))

    def step(self, i: int, v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The sample after step ``i`` from the velocity ``v`` at ``x``."""
        m_t = x - float(self.sig[i]) * v
        if i > 0:
            x = self._correct(i, m_t, self.last_sample, self.this_order)
        self.outputs = (self.outputs + [m_t])[-self.order:]
        order = min(self.order, self.steps - i, self.lower_order_nums + 1)
        self.this_order = order
        self.last_sample = x
        x_next = self._predict(i, x, order)
        self.lower_order_nums = min(self.lower_order_nums + 1, self.order)
        return x_next
