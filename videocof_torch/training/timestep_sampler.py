"""Uniform timestep-band sampling across data-parallel groups.

Counterpart of `videocof_tpu/training/timestep_sampler.py`: [0, num_train)
is split into ``group_num`` bands keyed by the data-parallel rank, so each
group trains on its own noise band every step. Draws come from a
``torch.Generator`` (not JAX's bits)."""

from __future__ import annotations

from typing import Tuple

import torch


class DiscreteSampling:
    def __init__(self, group_num: int, num_train_timesteps: int = 1000,
                 uniform_sampling: bool = True):
        self.group_num = max(1, group_num)
        self.num_train_timesteps = num_train_timesteps
        self.uniform_sampling = uniform_sampling
        self.band = num_train_timesteps // self.group_num

    def group_index(self, dp_rank: int) -> int:
        return dp_rank % self.group_num

    def bounds(self, dp_rank: int = 0) -> Tuple[int, int]:
        """[lo, hi) of this rank's band (the whole range when uniform
        sampling is off)."""
        if not self.uniform_sampling:
            return 0, self.num_train_timesteps
        g = self.group_index(dp_rank)
        hi = (self.num_train_timesteps if g == self.group_num - 1
              else (g + 1) * self.band)
        return g * self.band, hi

    def sample(self, generator: torch.Generator, batch: int,
               dp_rank: int = 0) -> torch.Tensor:
        """Integer timesteps [batch] (int64, on the generator's device) drawn
        uniformly from this rank's band."""
        lo, hi = self.bounds(dp_rank)
        return torch.randint(lo, hi, (batch,), generator=generator,
                             device=generator.device)
