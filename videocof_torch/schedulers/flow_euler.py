"""Flow-matching Euler sampler: x_{i+1} = x_i + (sigma_{i+1} - sigma_i) * v.

Counterpart of `videocof_tpu/schedulers/flow_euler.py` (diffusers'
FlowMatchEulerDiscreteScheduler, which the reference uses verbatim).
Stateless; the sigma grid is float64 numpy on the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class EulerState(NamedTuple):
    """Empty: kept for the samplers' common interface."""


class FlowEulerScheduler:
    order = 1

    def __init__(self, num_train_timesteps: int = 1000, shift: float = 1.0):
        self.num_train_timesteps = num_train_timesteps
        self.default_shift = shift
        self.sigmas: Optional[np.ndarray] = None
        self.timesteps: Optional[np.ndarray] = None

    def set_timesteps(self, num_inference_steps: int,
                      shift: Optional[float] = None,
                      mu: Optional[float] = None) -> np.ndarray:
        """diffusers' grid: with ``mu``, linspace(1, 1/T) under the
        exponential time shift; with a static shift, linspace(1, shifted
        1/T) shifted again (the scheduler shifts its training sigmas at
        construction and once more here). Timesteps are sigma * T as floats,
        not truncated."""
        shift = self.default_shift if shift is None else shift
        T = self.num_train_timesteps
        if mu is not None:
            sigmas = np.linspace(1.0, 1.0 / T, num_inference_steps,
                                 dtype=np.float64)
            sigmas = np.exp(mu) / (np.exp(mu) + (1.0 / sigmas - 1.0))
        else:
            smin = (shift * (1.0 / T)) / (1.0 + (shift - 1.0) * (1.0 / T))
            sigmas = np.linspace(1.0, smin, num_inference_steps,
                                 dtype=np.float64)
            sigmas = shift * sigmas / (1.0 + (shift - 1.0) * sigmas)
        self.timesteps = (sigmas * T).astype(np.float64)
        self.sigmas = np.concatenate([sigmas, [0.0]])
        self.num_inference_steps = num_inference_steps
        return self.timesteps

    def init_state(self, latents: torch.Tensor) -> EulerState:
        return EulerState()

    def step(self, model_output: torch.Tensor, step_index: int,
             sample: torch.Tensor, state: EulerState
             ) -> Tuple[torch.Tensor, EulerState]:
        dt = float(self.sigmas[step_index + 1] - self.sigmas[step_index])
        return (sample + dt * model_output).to(sample.dtype), state
