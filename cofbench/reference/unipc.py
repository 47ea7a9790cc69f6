"""Flow-UniPC (bh2, predict x0, order 2 with lower orders on the last steps,
final sigma 0), the sampler of Wan's ``FlowUniPCMultistepScheduler``: a
frozen copy of the update rule, its coefficients in float64."""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def sigmas(steps: int, shift: float, train_steps: int = 1000) -> np.ndarray:
    """Shifted sigmas from 1 - 1/T down to 0, with a trailing 0."""
    s = np.linspace(1.0 - 1.0 / train_steps, 0.0, steps + 1)[:-1]
    s = shift * s / (1.0 + (shift - 1.0) * s)
    return np.concatenate([s, [0.0]])


def timesteps(steps: int, shift: float, train_steps: int = 1000) -> np.ndarray:
    return (sigmas(steps, shift, train_steps)[:-1] * train_steps).astype(
        np.int64)


def _lam(s):
    with np.errstate(divide="ignore"):
        return np.log(1.0 - s) - np.log(s)


def _rhos(rks, hh, order):
    """Solve UniPC's system R rho = b (bh2: B(h) = expm1(h))."""
    b_h = np.expm1(hh)
    h_phi_k = b_h / hh - 1.0
    fact, R, b = 1, [], []
    for k in range(1, order + 1):
        R.append(rks ** (k - 1))
        b.append(h_phi_k * fact / b_h)
        fact *= k + 1
        h_phi_k = h_phi_k / hh - 1.0 / fact
    return np.stack(R), np.array(b)


class UniPC:
    def __init__(self, steps: int, shift: float, order: int = 2):
        self.s = sigmas(steps, shift)
        self.steps, self.order = steps, order
        self.models: List[torch.Tensor] = []
        self.orders: List[int] = []
        self.last = None

    def step(self, v: torch.Tensor, i: int, x: torch.Tensor) -> torch.Tensor:
        s = self.s
        m = x - float(s[i]) * v
        if i > 0:                       # corrector over step i-1's predictor
            order = self.orders[-1]
            a_t = 1.0 - s[i]
            h = _lam(s[i]) - _lam(s[i - 1])
            ab = float(a_t * np.expm1(-h))
            m0 = self.models[-1]
            xc = float(s[i] / s[i - 1]) * self.last - ab * m0
            if order == 1:
                rho_t = 0.5
            else:
                rks = np.array([(_lam(s[i - 1 - k]) - _lam(s[i - 1])) / h
                                for k in range(1, order)] + [1.0])
                R, b = _rhos(rks, -h, order)
                rhos = np.linalg.solve(R, b)
                for k in range(1, order):
                    d = (self.models[-1 - k] - m0) / float(rks[k - 1])
                    xc = xc - ab * float(rhos[k - 1]) * d
                rho_t = rhos[-1]
            x = xc - ab * float(rho_t) * (m - m0)
        self.models.append(m)
        order = min(self.order, self.steps - i, i + 1)
        self.orders.append(order)
        self.last = x
        if s[i + 1] == 0.0:
            return m
        a_t = 1.0 - s[i + 1]
        h = _lam(s[i + 1]) - _lam(s[i])
        ab = float(a_t * np.expm1(-h))
        out = float(s[i + 1] / s[i]) * x - ab * m
        if order >= 2:
            rks = np.array([(_lam(s[i - k]) - _lam(s[i])) / h
                            for k in range(1, order)] + [1.0])
            if order == 2:
                rhos = np.array([0.5])
            else:
                R, b = _rhos(rks, -h, order)
                rhos = np.linalg.solve(R[:-1, :-1], b[:-1])
            for k in range(1, order):
                d = (self.models[-1 - k] - m) / float(rks[k - 1])
                out = out - ab * float(rhos[k - 1]) * d
        return out
