"""DPM-Solver++ (multistep, midpoint) for rectified flow, solver order 1-3.

Counterpart of `videocof_tpu/schedulers/flow_dpm.py` (the reference's
`fm_solvers.py` with its defaults: "dpmsolver++", "midpoint", final sigma
zero, flow prediction), on the grid of `get_sampling_sigmas`, which starts at
sigma 1 (UniPC's starts at 1 - 1/T). As in the UniPC port, every per-step
coefficient is built once in float64 numpy; ``step`` is a few multiply-adds.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .common import lam


def get_sampling_sigmas(num_inference_steps: int, shift: float) -> np.ndarray:
    """linspace(1, 0, steps + 1)[:steps], shifted."""
    sigma = np.linspace(1.0, 0.0, num_inference_steps + 1,
                        dtype=np.float64)[:num_inference_steps]
    return shift * sigma / (1.0 + (shift - 1.0) * sigma)


class DPMState(NamedTuple):
    m0: torch.Tensor   # newest x0 prediction
    m1: torch.Tensor   # second newest (order 3 only)


@dataclasses.dataclass(frozen=True)
class _StepPlan:
    order: int
    ratio: float         # sigma_t / sigma_s0
    c_m0: float          # -alpha_t * (exp(-h) - 1)
    c_d1: float          # midpoint D1 coefficient (order 2), D1_0's (order 3)
    r0inv: float         # h / h_0
    c_diff: float = 0.0  # order 3: coefficient of (D1_0 - D1_1)
    r1inv: float = 0.0   # h / h_1


class FlowDPMScheduler:
    order = 1

    def __init__(self, num_train_timesteps: int = 1000, solver_order: int = 2,
                 shift: float = 1.0, lower_order_final: bool = True):
        if solver_order not in (1, 2, 3):
            raise ValueError(f"solver_order {solver_order}")
        self.num_train_timesteps = num_train_timesteps
        self.solver_order = solver_order
        self.default_shift = shift
        self.lower_order_final = lower_order_final
        self.sigmas: Optional[np.ndarray] = None
        self.timesteps: Optional[np.ndarray] = None
        self.plans: List[_StepPlan] = []

    def set_timesteps(self, num_inference_steps: int,
                      shift: Optional[float] = None,
                      sigmas: Optional[np.ndarray] = None) -> np.ndarray:
        shift = self.default_shift if shift is None else shift
        if sigmas is None:
            sigmas = get_sampling_sigmas(num_inference_steps, shift)
        sigmas = np.asarray(sigmas, dtype=np.float64)
        self.timesteps = (sigmas * self.num_train_timesteps).astype(np.int64)
        self.sigmas = np.concatenate([sigmas, [0.0]])
        self.num_inference_steps = len(self.timesteps)
        self.plans = self._build_plans()
        return self.timesteps

    def _build_plans(self) -> List[_StepPlan]:
        s = self.sigmas
        N = self.num_inference_steps
        plans = []
        with np.errstate(divide="ignore", invalid="ignore"):
            for i in range(N):
                # warm-up at the first steps; the final step is first order
                # (final sigma zero); the second last drops to order 2 when
                # lower_order_final and N < 15
                low_second = (i == N - 2 and self.lower_order_final
                              and N < 15)
                if self.solver_order == 1 or i < 1 or i == N - 1:
                    order = 1
                elif self.solver_order == 2 or i < 2 or low_second:
                    order = 2
                else:
                    order = 3
                sig_t, sig_s0 = s[i + 1], s[i]
                a_t = 1.0 - sig_t
                if sig_t == 0.0:
                    plans.append(_StepPlan(1, 0.0, float(a_t), 0.0, 0.0))
                    continue
                h = lam(sig_t) - lam(sig_s0)
                em = float(np.expm1(-h))
                if order == 1:
                    plans.append(_StepPlan(1, float(sig_t / sig_s0),
                                           float(-a_t * em), 0.0, 0.0))
                elif order == 2:
                    r0 = (lam(sig_s0) - lam(s[i - 1])) / h
                    plans.append(_StepPlan(2, float(sig_t / sig_s0),
                                           float(-a_t * em),
                                           float(-0.5 * a_t * em),
                                           float(1.0 / r0)))
                else:
                    # x = ratio x - a_t em D0 + A D1 - C D2 with
                    # D1 = D1_0 + w (D1_0 - D1_1), D2 = (D1_0 - D1_1)/(r0+r1),
                    # folded into c_d1 on D1_0 and c_diff on (D1_0 - D1_1)
                    r0 = (lam(sig_s0) - lam(s[i - 1])) / h
                    r1 = (lam(s[i - 1]) - lam(s[i - 2])) / h
                    A = a_t * (em / h + 1.0)
                    C = -a_t * ((em + h) / h**2 - 0.5)
                    c_diff = A * (r0 / (r0 + r1)) + C / (r0 + r1)
                    plans.append(_StepPlan(3, float(sig_t / sig_s0),
                                           float(-a_t * em), float(A),
                                           float(1.0 / r0),
                                           c_diff=float(c_diff),
                                           r1inv=float(1.0 / r1)))
        return plans

    def init_state(self, latents: torch.Tensor) -> DPMState:
        z = torch.zeros_like(latents)
        return DPMState(m0=z, m1=z)

    def step(self, model_output: torch.Tensor, step_index: int,
             sample: torch.Tensor, state: DPMState
             ) -> Tuple[torch.Tensor, DPMState]:
        plan = self.plans[step_index]
        m0 = sample - float(self.sigmas[step_index]) * model_output
        x = plan.ratio * sample.float() + plan.c_m0 * m0
        if plan.order >= 2:
            d1_0 = (m0 - state.m0) * plan.r0inv
            x = x + plan.c_d1 * d1_0
        if plan.order >= 3:
            d1_1 = (state.m0 - state.m1) * plan.r1inv
            x = x + plan.c_diff * (d1_0 - d1_1)
        return x.to(sample.dtype), DPMState(m0=m0, m1=state.m0)
