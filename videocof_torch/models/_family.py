"""Pieces shared by the non-Wan families (CogVideoX, Flux, QwenImage): the
attention call of their joint text+image blocks, their small modules (an
AdaLN's linear, the embedders' MLP, the blocks' feed-forward), the random
draw of their weights, and the reading of a diffusers ``config.json``."""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict

import torch
from torch import nn

from ..ops import attention


def attend(q, k, v, mask=None, backend=None):
    """``ops.attention``, or the sequence-parallel attention when
    ``backend`` is a callable ``(q, k, v, mask=)`` (`parallel`)."""
    if callable(backend):
        return backend(q, k, v, mask=mask)
    return attention(q, k, v, mask=mask, backend=backend)


def linear(din: int, dout: int, dtype, device) -> nn.Linear:
    return nn.Linear(din, dout, bias=True, dtype=dtype, device=device)


class Lin(nn.Module):
    """An AdaLN's one fp32 linear, ``lin``."""

    def __init__(self, din, dout, device):
        super().__init__()
        self.lin = linear(din, dout, torch.float32, device)


class MLP(nn.Module):
    """fc1 (din -> d) and fc2 (d -> d): the timestep and text embedders."""

    def __init__(self, din, d, dtype, device):
        super().__init__()
        self.fc1 = linear(din, d, dtype, device)
        self.fc2 = linear(d, d, dtype, device)


class FF(nn.Module):
    """The blocks' feed-forward: fc1 (d -> 4d), gelu-tanh, fc2 (4d -> d)."""

    def __init__(self, d, dtype, device):
        super().__init__()
        self.fc1 = linear(d, 4 * d, dtype, device)
        self.fc2 = linear(4 * d, d, dtype, device)


@torch.no_grad()
def init_uniform_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw ``model``'s weights as the JAX inits do: every 2-D ``weight``
    (a linear's [dout, din]) uniform in ±1/sqrt(din), biases zero, norm
    weights and scales one (as built). Returns ``model``."""
    gdev = generator.device
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight" and p.dim() == 2:
            bound = 1.0 / math.sqrt(p.shape[1])
            r = torch.empty(p.shape, device=gdev).uniform_(-bound, bound,
                                                          generator=generator)
            p.copy_(r)
        elif leaf == "bias":
            p.zero_()
    return model


def read_config(model_dir: str, keys, tuples=()) -> Dict[str, Any]:
    """The fields ``keys`` of ``model_dir``'s diffusers ``config.json``
    that are present and not null; those in ``tuples`` as tuples."""
    with open(os.path.join(model_dir, "config.json")) as f:
        raw = json.load(f)
    kw = {k: raw[k] for k in keys if k in raw and raw[k] is not None}
    for k in tuples:
        if k in kw:
            kw[k] = tuple(kw[k])
    return kw
