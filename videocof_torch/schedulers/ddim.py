"""DDIM sampler (eta 0, v-prediction) for the CogVideoX family.

Counterpart of `videocof_tpu/schedulers/ddim.py` (diffusers'
``CogVideoXDDIMScheduler`` with the CogVideoX checkpoints' configuration:
scaled-linear betas from 0.00085 to 0.012, an SNR shift of 3, betas
rescaled to zero terminal SNR, "trailing" timestep spacing). The
coefficients are float64 numpy on the host, as in JAX; only the step's
arithmetic runs in torch, in fp32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


def _rescale_zero_terminal_snr(alphas_cumprod: np.ndarray) -> np.ndarray:
    """Shift and scale sqrt(alpha_bar) so that the last step has zero SNR
    and the first keeps its value (Lin et al. 2023)."""
    s = np.sqrt(alphas_cumprod)
    s0, sT = s[0].copy(), s[-1].copy()
    s = s - sT
    s = s * s0 / (s0 - sT)
    return s ** 2


class DDIMState(NamedTuple):
    """Empty: kept for the samplers' common interface."""


class DDIMScheduler:
    """eta 0 DDIM on a v-prediction model."""

    def __init__(self, num_train_timesteps: int = 1000,
                 beta_start: float = 0.00085, beta_end: float = 0.012,
                 snr_shift_scale: float = 3.0,
                 rescale_betas_zero_snr: bool = True):
        self.num_train_timesteps = num_train_timesteps
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                            num_train_timesteps, dtype=np.float64) ** 2
        ac = np.cumprod(1.0 - betas)
        # the SNR shift: alpha_bar / (s + (1 - s) alpha_bar)
        ac = ac / (snr_shift_scale + (1.0 - snr_shift_scale) * ac)
        if rescale_betas_zero_snr:
            ac = _rescale_zero_terminal_snr(ac)
        self.alphas_cumprod = ac
        self.timesteps: Optional[np.ndarray] = None
        self._coeffs: Optional[np.ndarray] = None

    def set_timesteps(self, num_inference_steps: int,
                      shift: Optional[float] = None,
                      mu: Optional[float] = None) -> np.ndarray:
        """"trailing" spacing with a float stride (``arange(T, 0, -T /
        steps).round() - 1``), so a step count that does not divide T still
        ends near t = 0; the previous timestep is t - T // steps, as in
        diffusers' step. ``shift`` and ``mu`` are taken and ignored (the
        samplers' common signature)."""
        T = self.num_train_timesteps
        ts = (np.round(np.arange(T, 0, -T / num_inference_steps))
              .astype(np.int64) - 1)[:num_inference_steps]
        stride = T // num_inference_steps
        self.timesteps = ts.astype(np.float64)
        self.num_inference_steps = num_inference_steps
        # per step (sqrt a_t, sqrt(1 - a_t), sqrt a_prev, sqrt(1 - a_prev))
        coeffs = np.zeros((num_inference_steps, 4), np.float64)
        for i, t in enumerate(ts):
            prev_t = int(t) - stride
            a_t = self.alphas_cumprod[int(t)]
            a_prev = self.alphas_cumprod[prev_t] if prev_t >= 0 else 1.0
            coeffs[i] = (np.sqrt(a_t), np.sqrt(1.0 - a_t),
                         np.sqrt(a_prev), np.sqrt(1.0 - a_prev))
        self._coeffs = coeffs
        return self.timesteps

    def init_state(self, latents: torch.Tensor) -> DDIMState:
        return DDIMState()

    def step(self, model_output: torch.Tensor, step_index: int,
             sample: torch.Tensor, state: DDIMState
             ) -> Tuple[torch.Tensor, DDIMState]:
        sa, s1a, sap, s1ap = (float(c) for c in self._coeffs[step_index])
        v = model_output.float()
        x = sample.float()
        x0 = sa * x - s1a * v
        eps = sa * v + s1a * x
        return (sap * x0 + s1ap * eps).to(sample.dtype), state

    def add_noise(self, original: torch.Tensor, noise: torch.Tensor,
                  timestep) -> torch.Tensor:
        a = self.alphas_cumprod[int(timestep)]
        return (np.sqrt(a) * original + np.sqrt(1.0 - a) * noise
                ).to(original.dtype)

    def plan_arrays(self) -> dict:
        """The per-step table of the step as one product each: prev = c_x x
        + c_v v, with c_x = sqrt(a_prev) sqrt(a_t) + sqrt(1 - a_prev)
        sqrt(1 - a_t) and c_v = sqrt(1 - a_prev) sqrt(a_t) - sqrt(a_prev)
        sqrt(1 - a_t)."""
        c = self._coeffs
        c_x = c[:, 2] * c[:, 0] + c[:, 3] * c[:, 1]
        c_v = -c[:, 2] * c[:, 1] + c[:, 3] * c[:, 0]
        return {"kind": "ddim", "timesteps": np.asarray(self.timesteps),
                "c_x": c_x, "c_v": c_v}
