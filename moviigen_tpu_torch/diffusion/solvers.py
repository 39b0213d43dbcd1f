"""Flow-matching ODE samplers: UniPC and DPM-Solver++.

Counterpart of ``moviigen_tpu/diffusion/solvers.py`` (ref
``wan/utils/fm_solvers_unipc.py`` and ``wan/utils/fm_solvers.py``). The
sigma schedule is fixed at ``set_timesteps``, so every per-step scalar
(log-SNR gaps, φ-functions, UniPC R/b solves, order warm-up/wind-down)
is computed on the host in float64 numpy; each device step is a linear
combination of the sample and a short history of model outputs, in fp32:

    m_t    = sample − σ_i · model_output                     (x0 convert)
    x_corr = A_c·x_last + B_c·m0 + C_c·m1 + … + D_c·m_t      (corrector)
    x_next = A_p·x_corr + B_p·m_t + C_p·m0 + …               (predictor)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def shift_sigmas(sigmas: np.ndarray, shift: float) -> np.ndarray:
    """σ' = s·σ / (1 + (s−1)·σ)   (ref: fm_solvers_unipc.py:112-115)."""
    return shift * sigmas / (1 + (shift - 1) * sigmas)


def get_sampling_sigmas(sampling_steps: int, shift: float) -> np.ndarray:
    """ref: fm_solvers.py:22-26 (used by the dpm++ pipeline branch)."""
    sigma = np.linspace(1, 0, sampling_steps + 1)[:sampling_steps]
    return shift_sigmas(sigma, shift)


def _lambda_of(sigma: np.ndarray) -> np.ndarray:
    """log-SNR λ = log(α) − log(σ) with α = 1 − σ (flow-match schedule)."""
    with np.errstate(divide="ignore"):
        return np.log(1.0 - sigma) - np.log(sigma)


@dataclasses.dataclass
class SolverState:
    """Sampler state: ``m_hist[k]`` is the converted model output from k
    steps ago; ``last_sample`` the corrected sample of the previous step
    (UniPC corrector input)."""

    m_hist: Tuple[torch.Tensor, ...]
    last_sample: torch.Tensor


def _linear_combine(coeffs: Sequence[float],
                    tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Σ cᵢ·tᵢ in fp32 (each coefficient rounded to fp32 first)."""
    out = None
    for c, t in zip(coeffs, tensors):
        term = float(np.float32(c)) * t.float()
        out = term if out is None else out + term
    return out


class _TableSolverBase:
    """Shared machinery: sigma schedule + coefficient-table execution."""

    def __init__(self, num_train_timesteps: int = 1000, shift: float = 1.0,
                 solver_order: int = 2):
        self.num_train_timesteps = num_train_timesteps
        self.shift = shift
        self.solver_order = solver_order
        alphas = np.linspace(1, 1 / num_train_timesteps,
                             num_train_timesteps)[::-1]
        sigmas = shift_sigmas(1.0 - alphas, shift)
        self.sigma_min = float(sigmas[-1])
        self.sigma_max = float(sigmas[0])
        self.sigmas: Optional[np.ndarray] = None
        self.timesteps: Optional[np.ndarray] = None
        self.num_inference_steps: Optional[int] = None

    def _base_sigmas(self, num_inference_steps: int,
                     custom_sigmas: Optional[np.ndarray],
                     shift: Optional[float]) -> np.ndarray:
        if custom_sigmas is None:
            sig = np.linspace(self.sigma_max, self.sigma_min,
                              num_inference_steps + 1)[:-1]
            sig = shift_sigmas(sig, self.shift if shift is None else shift)
        else:
            # custom sigmas are re-shifted by the config shift
            # (fm_solvers.py:255-259); the pipeline constructs with
            # shift=1, so this is an identity there
            sig = shift_sigmas(np.asarray(custom_sigmas, dtype=np.float64),
                               self.shift)
        return np.concatenate([sig, [0.0]]).astype(np.float64)

    def init_state(self, sample: torch.Tensor) -> SolverState:
        z = torch.zeros_like(sample, dtype=torch.float32)
        return SolverState(m_hist=tuple(z for _ in range(self.solver_order)),
                           last_sample=z)

    def convert_model_output(self, i: int, model_output: torch.Tensor,
                             sample: torch.Tensor) -> torch.Tensor:
        """x0 = sample − σᵢ·v   (ref fm_solvers_unipc.py:319-322)."""
        return sample.float() - float(self.sigmas[i]) * model_output.float()


class FlowUniPCMultistepScheduler(_TableSolverBase):
    """UniPC multistep predictor-corrector for flow matching
    (``predict_x0=True``, bh1/bh2, ``lower_order_final=True``)."""

    def __init__(self, num_train_timesteps: int = 1000,
                 solver_order: int = 2, shift: float = 1.0,
                 solver_type: str = "bh2",
                 lower_order_final: bool = True,
                 disable_corrector: Sequence[int] = ()):
        super().__init__(num_train_timesteps, shift, solver_order)
        if solver_type not in ("bh1", "bh2"):
            solver_type = "bh2"  # ref maps legacy names to bh2
        self.solver_type = solver_type
        self.lower_order_final = lower_order_final
        self.disable_corrector = set(disable_corrector)

    def set_timesteps(self, num_inference_steps: int,
                      shift: Optional[float] = None,
                      sigmas: Optional[np.ndarray] = None) -> None:
        sig = self._base_sigmas(num_inference_steps, sigmas, shift)
        self.sigmas = sig.astype(np.float32)
        self.timesteps = (sig[:-1] * self.num_train_timesteps).astype(np.int64)
        n = num_inference_steps
        self.num_inference_steps = n
        lam = _lambda_of(sig)

        # per-step effective orders (ref step(): fm_solvers_unipc.py:715-724)
        this_order = np.zeros(n, dtype=np.int64)
        lower_order_nums = 0
        for i in range(n):
            o = self.solver_order
            if self.lower_order_final:
                o = min(o, n - i)
            o = min(o, lower_order_nums + 1)
            this_order[i] = o
            if lower_order_nums < self.solver_order:
                lower_order_nums += 1

        k = self.solver_order
        self._corr = np.zeros((n, 1 + k + 1), dtype=np.float64)
        self._use_corr = np.zeros(n, dtype=bool)
        self._pred = np.zeros((n, 1 + k), dtype=np.float64)
        for i in range(n):
            if i > 0 and (i - 1) not in self.disable_corrector:
                self._use_corr[i] = True
                self._corr[i] = self._uni_c_coeffs(
                    i, int(this_order[i - 1]), lam, sig)
            self._pred[i] = self._uni_p_coeffs(i, int(this_order[i]), lam, sig)

    def _phi_terms(self, h: float):
        """hh = −h (predict_x0), hφ₁ = e^hh − 1, B_h per solver type."""
        hh = -h
        h_phi_1 = np.expm1(hh)
        B_h = hh if self.solver_type == "bh1" else np.expm1(hh)
        return hh, h_phi_1, B_h

    def _rb_solve(self, rks: np.ndarray, hh: float, h_phi_1: float,
                  B_h: float, order: int):
        """R·ρ=b system (ref fm_solvers_unipc.py:446-463)."""
        R, b = [], []
        h_phi_k = h_phi_1 / hh - 1
        fact = 1
        for j in range(1, order + 1):
            R.append(np.power(rks, j - 1))
            b.append(h_phi_k * fact / B_h)
            fact *= j + 1
            h_phi_k = h_phi_k / hh - 1 / fact
        return np.stack(R), np.asarray(b)

    def _uni_p_coeffs(self, i: int, order: int, lam, sig) -> np.ndarray:
        """Predictor linear coefficients over (x, m_t, m1, ..)."""
        k = self.solver_order
        out = np.zeros(1 + k)
        sigma_t, sigma_s0 = sig[i + 1], sig[i]
        alpha_t = 1.0 - sigma_t
        h = lam[i + 1] - lam[i]
        hh, h_phi_1, B_h = self._phi_terms(h)
        out[0] = sigma_t / sigma_s0 if sigma_s0 > 0 else 0.0
        out[1] = -alpha_t * h_phi_1
        if order > 1:
            rks = np.array([(lam[i - j] - lam[i]) / h
                            for j in range(1, order)] + [1.0])
            if order == 2:
                rhos_p = np.array([0.5])
            else:
                R, b = self._rb_solve(rks, hh, h_phi_1, B_h, order)
                rhos_p = np.linalg.solve(R[:-1, :-1], b[:-1])
            for j in range(1, order):
                c = -alpha_t * B_h * rhos_p[j - 1] / rks[j - 1]
                out[1 + j] = c
                out[1] -= c
        return out

    def _uni_c_coeffs(self, i: int, order: int, lam, sig) -> np.ndarray:
        """Corrector linear coefficients over (x_last, m0, m1, .., m_t)."""
        k = self.solver_order
        out = np.zeros(1 + k + 1)
        sigma_t, sigma_s0 = sig[i], sig[i - 1]
        alpha_t = 1.0 - sigma_t
        h = lam[i] - lam[i - 1]
        hh, h_phi_1, B_h = self._phi_terms(h)
        out[0] = sigma_t / sigma_s0
        out[1] = -alpha_t * h_phi_1
        if order == 1:
            rhos_c = np.array([0.5])
        else:
            rks = np.array([(lam[i - 1 - j] - lam[i - 1]) / h
                            for j in range(1, order)] + [1.0])
            R, b = self._rb_solve(rks, hh, h_phi_1, B_h, order)
            rhos_c = np.linalg.solve(R, b)
            for j in range(1, order):
                c = -alpha_t * B_h * rhos_c[j - 1] / rks[j - 1]
                out[1 + j] = c
                out[1] -= c
        d = -alpha_t * B_h * rhos_c[-1]
        out[-1] = d
        out[1] -= d
        return out

    def step(self, model_output: torch.Tensor, i: int, sample: torch.Tensor,
             state: SolverState) -> Tuple[torch.Tensor, SolverState]:
        """One predictor(-corrector) step at python step index ``i``."""
        if self.sigmas is None:
            raise RuntimeError("call set_timesteps first")
        m_t = self.convert_model_output(i, model_output, sample)
        x = sample.float()
        if self._use_corr[i]:
            x = _linear_combine(self._corr[i],
                                (state.last_sample, *state.m_hist, m_t))
        new_hist = (m_t,) + state.m_hist[:-1]
        x_next = _linear_combine(self._pred[i], (x, m_t, *state.m_hist[:-1]))
        return x_next, SolverState(m_hist=new_hist, last_sample=x)


class FlowDPMSolverMultistepScheduler(_TableSolverBase):
    """DPM-Solver++ multistep (orders 1–3, midpoint/heun) for flow
    matching, ``algorithm_type='dpmsolver++'``."""

    def __init__(self, num_train_timesteps: int = 1000,
                 solver_order: int = 2, shift: float = 1.0,
                 solver_type: str = "midpoint",
                 lower_order_final: bool = True,
                 euler_at_final: bool = False,
                 final_sigmas_type: str = "zero"):
        super().__init__(num_train_timesteps, shift, solver_order)
        if solver_type not in ("midpoint", "heun"):
            solver_type = "midpoint"
        self.solver_type = solver_type
        self.lower_order_final = lower_order_final
        self.euler_at_final = euler_at_final
        self.final_sigmas_type = final_sigmas_type

    def set_timesteps(self, num_inference_steps: int,
                      shift: Optional[float] = None,
                      sigmas: Optional[np.ndarray] = None) -> None:
        sig = self._base_sigmas(num_inference_steps, sigmas, shift)
        self.sigmas = sig.astype(np.float32)
        self.timesteps = (sig[:-1] * self.num_train_timesteps).astype(np.int64)
        n = num_inference_steps
        self.num_inference_steps = n
        lam = _lambda_of(sig)
        k = self.solver_order
        self._pred = np.zeros((n, 1 + 3), dtype=np.float64)
        lower_order_nums = 0
        for i in range(n):
            last = i == n - 1
            lower_final = last and (
                self.euler_at_final
                or (self.lower_order_final and n < 15)
                or self.final_sigmas_type == "zero")
            lower_second = (i == n - 2) and self.lower_order_final and n < 15
            if k == 1 or lower_order_nums < 1 or lower_final:
                order = 1
            elif k == 2 or lower_order_nums < 2 or lower_second:
                order = 2
            else:
                order = 3
            self._pred[i] = self._dpmpp_coeffs(i, order, lam, sig)
            if lower_order_nums < k:
                lower_order_nums += 1

    def _dpmpp_coeffs(self, i: int, order: int, lam, sig) -> np.ndarray:
        out = np.zeros(4)
        sigma_t, sigma_s0 = sig[i + 1], sig[i]
        alpha_t = 1.0 - sigma_t
        h = lam[i + 1] - lam[i]
        e = np.exp(-h) - 1.0  # exp(−h)−1; h=+inf at the final step → −1
        out[0] = sigma_t / sigma_s0 if sigma_s0 > 0 else 0.0
        out[1] = -alpha_t * e
        if order >= 2:
            h0 = lam[i] - lam[i - 1]
            r0 = h0 / h
            if order == 2:
                if self.solver_type == "midpoint":
                    c1 = -0.5 * alpha_t * e
                else:  # heun
                    c1 = alpha_t * (e / h + 1.0)
                with np.errstate(divide="ignore", invalid="ignore"):
                    c1r = c1 / r0
                if not np.isfinite(c1r):
                    c1r = 0.0  # r0 → ±inf limit (first sigma == 1.0)
                out[1] += c1r
                out[2] = -c1r
            else:  # order 3 (ref fm_solvers.py:658-671)
                h1 = lam[i - 1] - lam[i - 2]
                r1 = h1 / h
                cD1 = alpha_t * (e / h + 1.0)
                cD2 = -alpha_t * ((e + h) / h**2 - 0.5)
                a = 1.0 + r0 / (r0 + r1)
                b = -r0 / (r0 + r1)
                w10 = cD1 * a + cD2 * (1.0 / (r0 + r1))
                w11 = cD1 * b - cD2 * (1.0 / (r0 + r1))
                out[1] += w10 / r0
                out[2] += -w10 / r0 + w11 / r1
                out[3] += -w11 / r1
        return out

    def step(self, model_output: torch.Tensor, i: int, sample: torch.Tensor,
             state: SolverState) -> Tuple[torch.Tensor, SolverState]:
        if self.sigmas is None:
            raise RuntimeError("call set_timesteps first")
        m_t = self.convert_model_output(i, model_output, sample)
        new_hist = (m_t,) + state.m_hist[:-1]
        pc = self._pred[i]
        x_next = _linear_combine(
            pc[:1 + self.solver_order],
            (sample, m_t, *state.m_hist[:self.solver_order - 1]))
        return x_next, SolverState(m_hist=new_hist, last_sample=sample.float())


class FlowMatchScheduler:
    """Simple Euler flow-match scheduler with training helpers: the JAX
    package's ``FlowMatchScheduler`` (ref ``wan/utils/fm_solvers.py:
    860-934``; ``training_target = noise − sample``)."""

    def __init__(self, num_inference_steps: int = 100,
                 num_train_timesteps: int = 1000, shift: float = 3.0,
                 sigma_max: float = 1.0, sigma_min: float = 0.003 / 1.002,
                 extra_one_step: bool = False):
        self.num_train_timesteps = num_train_timesteps
        self.shift = shift
        self.sigma_max = sigma_max
        self.sigma_min = sigma_min
        self.extra_one_step = extra_one_step
        self.linear_timesteps_weights = None
        self.set_timesteps(num_inference_steps)

    def set_timesteps(self, num_inference_steps: int = 100,
                      denoising_strength: float = 1.0,
                      training: bool = False,
                      shift: Optional[float] = None) -> None:
        if shift is not None:
            self.shift = shift
        start = self.sigma_min + (self.sigma_max - self.sigma_min) \
            * denoising_strength
        n = num_inference_steps + 1 if self.extra_one_step \
            else num_inference_steps
        sig = np.linspace(start, self.sigma_min, n)[:num_inference_steps]
        sig = shift_sigmas(sig, self.shift)
        self.sigmas = sig.astype(np.float32)
        self.timesteps = (sig * self.num_train_timesteps).astype(np.float32)
        if training:
            x = self.timesteps
            y = np.exp(-2 * ((x - num_inference_steps / 2)
                             / num_inference_steps) ** 2)
            y_shifted = y - y.min()
            self.linear_timesteps_weights = (
                y_shifted * (num_inference_steps / y_shifted.sum()))

    def _timestep_id(self, timestep) -> int:
        return int(np.argmin(np.abs(self.timesteps - float(timestep))))

    def step(self, model_output: torch.Tensor, timestep,
             sample: torch.Tensor, to_final: bool = False) -> torch.Tensor:
        tid = self._timestep_id(timestep)
        sigma = self.sigmas[tid]
        if to_final or tid + 1 >= len(self.timesteps):
            sigma_next = 0.0
        else:
            sigma_next = self.sigmas[tid + 1]
        return sample + model_output * float(np.float32(sigma_next - sigma))

    def add_noise(self, original_samples: torch.Tensor, noise: torch.Tensor,
                  timestep) -> torch.Tensor:
        sigma = float(self.sigmas[self._timestep_id(timestep)])
        return (1 - sigma) * original_samples + sigma * noise

    def training_target(self, sample: torch.Tensor, noise: torch.Tensor,
                        timestep) -> torch.Tensor:
        return noise - sample

    def training_weight(self, timestep) -> float:
        return float(
            self.linear_timesteps_weights[self._timestep_id(timestep)])
