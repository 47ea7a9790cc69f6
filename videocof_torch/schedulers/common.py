"""Shared flow-matching schedule math (numpy float64 on the host).

Rectified-flow noising: x_t = (1 - sigma) * x0 + sigma * noise, with the model
predicting velocity v = noise - x0, so x0 = x_t - sigma * v. The "shift"
transform stretches the sigma grid toward the noisy end:
sigma' = s * sigma / (1 + (s - 1) * sigma).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def shift_sigma(sigmas: np.ndarray, shift: float) -> np.ndarray:
    return shift * sigmas / (1.0 + (shift - 1.0) * sigmas)


def time_shift_mu(sigmas: np.ndarray, mu: float, s: float = 1.0) -> np.ndarray:
    """The dynamic (resolution-aware) shift: e^mu / (e^mu + (1/t - 1)^s)."""
    return np.exp(mu) / (np.exp(mu) + (1.0 / sigmas - 1.0) ** s)


def flow_shift_sigmas(num_inference_steps: int, shift: float = 1.0,
                      num_train_timesteps: int = 1000
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (sigmas[steps+1] float64 with a trailing 0, timesteps[steps]
    int64): linspace from sigma_max = 1 - 1/T down to 0 over steps+1 points,
    drop the last, shift, append 0; timesteps are sigma * T truncated."""
    sigma_max = 1.0 - 1.0 / num_train_timesteps
    sigmas = np.linspace(sigma_max, 0.0, num_inference_steps + 1,
                         dtype=np.float64)[:-1]
    sigmas = shift_sigma(sigmas, shift)
    timesteps = (sigmas * num_train_timesteps).astype(np.int64)
    return np.concatenate([sigmas, [0.0]]), timesteps


def lam(sigma) -> np.ndarray:
    """lambda(sigma) = log(alpha) - log(sigma); +inf at sigma=0."""
    with np.errstate(divide="ignore"):
        return np.log(1.0 - sigma) - np.log(sigma)


def get_scheduler(name: str, **kwargs):
    """A sampler by name (aliases as in the JAX package: "flow" is "euler",
    "flow_unipc" "unipc", "flow_dpm++" "dpm++", "cogvideox_ddim"
    "ddim")."""
    from . import SCHEDULERS
    aliases = {"flow": "euler", "flow_unipc": "unipc", "flow_dpm++": "dpm++",
               "cogvideox_ddim": "ddim"}
    key = name.lower()
    key = aliases.get(key, key)
    if key not in SCHEDULERS:
        raise ValueError(f"unknown scheduler {name!r}; have "
                         f"{sorted(SCHEDULERS)}")
    return SCHEDULERS[key](**kwargs)
