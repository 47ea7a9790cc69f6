"""Flow-matching training steps on one device.

Counterpart of `videocof_tpu/training/train_step.py`: the chain-of-frames
flow-matching loss, a full fine-tuning step (`make_train_step`) and a LoRA
step (`make_lora_train_step`), each returning ``(init_fn, step_fn)``. The
mesh, Ulysses and tensor-parallel arguments of the JAX steps are not ported
(one device). PyTorch updates in place: ``step_fn`` returns the state it was
given, with its parameters, optimizer state and step count moved on.

The optimizer is optax's ``chain(clip_by_global_norm(max_norm),
adamw(lr, weight_decay))``: `ClipAdamW` clips as optax does (``g / ||g|| *
max_norm`` only when ``||g|| >= max_norm``, no epsilon) and steps
``torch.optim.AdamW``, whose update is optax's adamw update.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch
from torch import nn

from ..models.lora import LoRAAdapters, init_lora_adapters
from ..models.wan_dit import WanDiT


def flow_matching_loss(dit: WanDiT, x0, context, rope_cos, rope_sin,
                       timesteps, noise, attn_backend=None,
                       remat: Union[bool, str] = True, frame_mask=None,
                       lora=None):
    """Rectified-flow loss: x_t = (1 - sigma) x0 + sigma n, target n - x0.

    ``remat`` is the blocks' checkpoint policy (`wan_dit.remat_policy`).
    ``frame_mask`` [F] (1 = denoised frame, 0 = clean conditioning frame) is
    the chain-of-frames objective: source latent frames stay clean at every
    t and leave the loss. ``lora`` = (adapters, scale) as for `WanDiT`."""
    sigma = (timesteps.float() / 1000.0)[:, None, None, None, None]
    x_t = (1.0 - sigma) * x0 + sigma * noise
    target = noise - x0
    if frame_mask is not None:
        m = frame_mask.float()[None, None, :, None, None]
        x_t = m * x_t + (1.0 - m) * x0
        target = target * m
    pred = dit(x_t, timesteps.float(), context, rope_cos, rope_sin,
               attn_backend=attn_backend, lora=lora, remat_blocks=remat)
    if frame_mask is not None:
        err = (pred - target).square() * m
        return err.mean() / m.mean().clamp(min=1e-8)
    return (pred - target).square().mean()


# ------------------------------------------------------------------ optimizer

@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: every gradient becomes
    ``g / ||g|| * max_norm`` when the global L2 norm ``||g|| >= max_norm``,
    and stays as it is otherwise. No host synchronisation."""
    if not grads:
        return
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))


class ClipAdamW:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(lr,
    weight_decay))`` over ``params`` (no clip when ``max_norm`` is None)."""

    def __init__(self, params: Iterable[nn.Parameter], lr: float,
                 weight_decay: float, max_norm: Optional[float] = None):
        self.params = list(params)
        self.max_norm = max_norm
        self.adamw = torch.optim.AdamW(self.params, lr=lr, betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=weight_decay)

    def step(self) -> None:
        if self.max_norm is not None:
            clip_by_global_norm_([p.grad for p in self.params
                                  if p.grad is not None], self.max_norm)
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)


def adamw(lr: float, weight_decay: float, grad_clip: Optional[float] = None
          ) -> Callable[[Iterable[nn.Parameter]], ClipAdamW]:
    """An optimizer factory (params -> `ClipAdamW`), the role of an optax
    transformation in the JAX steps."""
    return lambda params: ClipAdamW(params, lr, weight_decay, grad_clip)


# ---------------------------------------------------------------------- steps

class StageTimer:
    """Wall seconds per stage into ``timings`` (a dict, or None to record
    nothing); the device is synchronized at each boundary only when
    recording."""

    def __init__(self, timings: Optional[Dict[str, float]],
                 device: torch.device):
        self.timings, self.device = timings, device
        self.t0 = time.perf_counter()

    def tick(self, label: str) -> None:
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings[label] = now - self.t0
        self.t0 = now


@dataclass
class TrainState:
    params: WanDiT
    optimizer: ClipAdamW
    step: int = 0


@dataclass
class LoRATrainState:
    adapters: LoRAAdapters
    optimizer: ClipAdamW
    step: int = 0


def _run_step(state, optimizer, loss_fn, batch, noise, generator, timings):
    x0 = batch["x0"]
    clock = StageTimer(timings, x0.device)
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator, device=x0.device,
                            dtype=x0.dtype)
    loss = loss_fn(x0, noise)
    loss.backward()
    clock.tick("forward+backward")
    optimizer.step()
    clock.tick("optimizer")
    state.step += 1
    return state, loss.detach()


def _loss(dit, batch, x0, noise, attn_backend, remat, lora=None):
    return flow_matching_loss(
        dit, x0, batch["context"], batch["rope_cos"], batch["rope_sin"],
        batch["timesteps"], noise, attn_backend=attn_backend, remat=remat,
        frame_mask=batch.get("frame_mask"), lora=lora)


def make_train_step(dit: WanDiT, optimizer=None,
                    remat: Union[bool, str] = True,
                    attn_backend: Optional[str] = None
                    ) -> Tuple[Callable, Callable]:
    """Full fine-tuning: (init_fn, step_fn).

    ``init_fn()`` -> `TrainState` over every parameter of ``dit``;
    ``step_fn(state, batch, noise=None, generator=None, timings=None)`` ->
    (state, loss). ``batch`` holds ``x0`` [B, C, F, H, W], ``context``,
    ``rope_cos``, ``rope_sin``, ``timesteps`` [B] and optionally
    ``frame_mask``; ``noise`` replaces the draw from ``generator`` (JAX
    draws it inside the step from its key); ``timings`` (a dict) receives the
    stage walls "forward+backward" and "optimizer". ``remat``: False, True,
    a policy name or 'save_names:<n1,n2>' (`wan_dit.remat_policy`; an
    unknown name raises ValueError at the first step, as in JAX)."""
    optimizer = optimizer or adamw(1e-5, weight_decay=1e-3)

    def init_fn() -> TrainState:
        dit.requires_grad_(True)
        return TrainState(dit, optimizer(dit.parameters()))

    def step_fn(state: TrainState, batch, noise=None, generator=None,
                timings=None):
        return _run_step(
            state, state.optimizer,
            lambda x0, n: _loss(state.params, batch, x0, n, attn_backend,
                                remat),
            batch, noise, generator, timings)

    return init_fn, step_fn


def make_lora_train_step(dit: WanDiT, optimizer=None, rank: int = 16,
                         remat: Union[bool, str] = True,
                         attn_backend: Optional[str] = None
                         ) -> Tuple[Callable, Callable]:
    """LoRA-adapter training over a frozen base: (init_fn, step_fn).

    The base weights are frozen (``requires_grad_(False)``), so only the
    adapters carry gradients and optimizer state; they fuse into each
    block's weights inside that block's call. ``init_fn(generator=None,
    adapters=None)`` -> `LoRATrainState` with adapters drawn from
    ``generator`` (`init_lora_adapters`) or the ``adapters`` given;
    ``step_fn`` as in `make_train_step`."""
    optimizer = optimizer or adamw(1e-4, weight_decay=0.0)

    def init_fn(generator: Optional[torch.Generator] = None,
                adapters: Optional[LoRAAdapters] = None) -> LoRATrainState:
        dit.requires_grad_(False)
        if adapters is None:
            adapters = init_lora_adapters(dit.cfg, generator, rank=rank)
        return LoRATrainState(adapters, optimizer(adapters.parameters()))

    def step_fn(state: LoRATrainState, batch, noise=None, generator=None,
                timings=None):
        lora = (state.adapters, state.adapters.scale)
        return _run_step(
            state, state.optimizer,
            lambda x0, n: _loss(dit, batch, x0, n, attn_backend, remat, lora),
            batch, noise, generator, timings)

    return init_fn, step_fn
