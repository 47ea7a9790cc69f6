"""Flow-matching training steps, on one device or over a mesh.

Counterpart of `videocof_tpu/training/train_step.py`: the chain-of-frames
flow-matching loss, a full fine-tuning step (`make_train_step`) and a LoRA
step (`make_lora_train_step`), each returning ``(init_fn, step_fn)``.
PyTorch updates in place: ``step_fn`` returns the state it was given, with
its parameters, optimizer state and step count moved on.

With a ``mesh`` (`parallel.make_mesh`) the step is explicit SPMD, one rank
per process: the batch is split over ``data`` (each rank is given its own
rows), the DiT forward runs Ulysses sequence-parallel over ``seq`` when
``seq > 1`` (the loss is taken on the prediction gathered at the head exit,
so every rank of a seq group computes the same loss), the gradients of the
parameters every seq rank holds whole are summed over the seq group (each
rank's backward saw only its own tokens) and then averaged over the data
group, and the clip takes the global norm after those reductions. A full
fine-tune shards its parameters and AdamW moments over ``data`` with FSDP
(`parallel.apply_fsdp`). Over a ``model`` axis of more than one rank the
full fine-tune is also Megatron tensor-parallel (JAX's 3D layout): each
rank's heads and FFN shard (`parallel.apply_tp`), then FSDP over ``data``
on the dim TP left free (`parallel.tp_fsdp_param_shardings`). The *f*/*g*
collectives of the TP forward give every model rank the whole gradient of
the parameters it holds whole, so no gradient is reduced over ``model``;
the clip's norm sums the squares of the TP shards over it.

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
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from ..models.lora import LoRAAdapters, init_lora_adapters
from ..models.wan_dit import WanDiT


def flow_matching_loss(dit: WanDiT, x0, context, rope_cos, rope_sin,
                       timesteps, noise, attn_backend=None,
                       remat: Union[bool, str] = True, frame_mask=None,
                       lora=None, sp=None):
    """Rectified-flow loss: x_t = (1 - sigma) x0 + sigma n, target n - x0.

    ``remat`` is the blocks' checkpoint policy (`wan_dit.remat_policy`).
    ``frame_mask`` [F] (1 = denoised frame, 0 = clean conditioning frame) is
    the chain-of-frames objective: source latent frames stay clean at every
    t and leave the loss. ``lora`` = (adapters, scale) and ``sp`` as for
    `WanDiT`."""
    sigma = (timesteps.float() / 1000.0)[:, None, None, None, None]
    x_t = (1.0 - sigma) * x0 + sigma * noise
    target = noise - x0
    if frame_mask is not None:
        m = frame_mask.float()[None, None, :, None, None]
        x_t = m * x_t + (1.0 - m) * x0
        target = target * m
    pred = dit(x_t, timesteps.float(), context, rope_cos, rope_sin,
               attn_backend=attn_backend, lora=lora, remat_blocks=remat,
               sp=sp)
    if frame_mask is not None:
        err = (pred - target).square() * m
        return err.mean() / m.mean().clamp(min=1e-8)
    return (pred - target).square().mean()


# ------------------------------------------------------------------ optimizer

def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (FSDP), a plain tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm_sq: Optional[Callable] = None) -> None:
    """optax.clip_by_global_norm in place: every gradient becomes
    ``g / ||g|| * max_norm`` when the global L2 norm ``||g|| >= max_norm``,
    and stays as it is otherwise. No host synchronisation. ``norm_sq``
    (grads -> ||g||^2) replaces the local sum of squares (over a mesh,
    `_MeshReduce.norm_sq`)."""
    if not grads:
        return
    if norm_sq is None:
        norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    else:
        norm = torch.sqrt(norm_sq(grads))
    keep = norm < max_norm
    for g in map(_local, grads):
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))


class _MeshReduce:
    """The step's collectives over a ('data', 'seq', 'model') mesh: the
    gradient reductions, the global norm and the loss's data mean.
    Gradients of FSDP-sharded parameters (DTensors) arrive averaged over
    ``data`` by FSDP's reduce-scatter and are summed over ``seq`` here;
    every other gradient is summed over ``seq`` and averaged over
    ``data``."""

    def __init__(self, mesh):
        self.seq = mesh.get_group("seq")
        self.data = mesh.get_group("data")
        self.model = mesh.get_group("model")
        self.seq_size = dist.get_world_size(self.seq)
        self.data_size = dist.get_world_size(self.data)
        self.data_rank = dist.get_rank(self.data)
        # the TP-cut parameters (`tp_sharded`), and which of the gradients
        # the clip is given are theirs
        self.tp_sharded = frozenset()
        self._tp_grads = []

    @staticmethod
    def _all_reduce(tensors, group):
        """SUM over ``group``, one flat buffer per dtype."""
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.all_reduce(flat, group=group)
            for t, r in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(r.view_as(t))

    @torch.no_grad()
    def reduce_grads(self, params) -> None:
        grads = [p.grad for p in params if p.grad is not None]
        self._tp_grads = [id(p) in self.tp_sharded for p in params
                          if p.grad is not None]
        if self.seq_size > 1:
            self._all_reduce([_local(g) for g in grads], self.seq)
        plain = [g for g in grads if not isinstance(g, DTensor)]
        if self.data_size > 1 and plain:
            self._all_reduce(plain, self.data)
            for g in plain:
                g.div_(self.data_size)

    @torch.no_grad()
    def norm_sq(self, grads) -> torch.Tensor:
        """||g||^2 over the whole of every gradient: the squares of the
        FSDP shards summed over ``data``, those of the TP shards over
        ``model``, those of whole gradients once (``grads`` in the order
        `reduce_grads` saw them)."""
        dev = grads[0].device
        # by [FSDP-sharded][TP-cut]: each part summed over the axes it is
        # sharded on
        sums = [[torch.zeros((), dtype=torch.float32, device=dev)
                 for _ in range(2)] for _ in range(2)]
        cut = self._tp_grads or [False] * len(grads)
        for g, tp in zip(grads, cut):
            sums[int(isinstance(g, DTensor))][int(tp)] += \
                _local(g).float().square().sum()
        for part, group in ((sums[1], self.data),
                            ([sums[0][1], sums[1][1]], self.model)):
            if dist.get_world_size(group) > 1:
                flat = torch.stack(part)
                dist.all_reduce(flat, group=group)
                for t, v in zip(part, flat.unbind()):
                    t.copy_(v)
        return sum(t for row in sums for t in row)

    @torch.no_grad()
    def mean_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The loss over the global batch: the data ranks' means averaged
        (equal rows per rank)."""
        loss = loss.detach().clone()
        if self.data_size > 1:
            dist.all_reduce(loss, group=self.data)
            loss /= self.data_size
        return loss


class ClipAdamW:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(lr,
    weight_decay))`` over ``params`` (no clip when ``max_norm`` is None)."""

    def __init__(self, params: Iterable[nn.Parameter], lr: float,
                 weight_decay: float, max_norm: Optional[float] = None):
        self.params = list(params)
        self.max_norm = max_norm
        # FSDP shards (DTensors) beside whole parameters: AdamW's
        # multi-tensor path takes one kind a device and dtype
        mixed = len({isinstance(p, DTensor) for p in self.params}) > 1
        self.adamw = torch.optim.AdamW(self.params, lr=lr, betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=weight_decay,
                                       foreach=False if mixed else None)

    def step(self, norm_sq: Optional[Callable] = None) -> None:
        """Clip and step; ``norm_sq`` (gradients -> ||g||^2) takes the
        clip's norm over a mesh (`_MeshReduce.norm_sq`)."""
        if self.max_norm is not None:
            clip_by_global_norm_([p.grad for p in self.params
                                  if p.grad is not None], self.max_norm,
                                 norm_sq)
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


def _run_step(state, optimizer, red, loss_fn, batch, noise, generator,
              timings):
    """One step; ``red`` (a `_MeshReduce`, or None off a mesh) reduces
    the gradients before the optimizer and gives the clip its norm."""
    x0 = batch["x0"]
    clock = StageTimer(timings, x0.device)
    if noise is None:
        # the global batch's noise, of which this rank keeps its rows: the
        # generator moves alike on every rank
        n_data = 1 if red is None else red.data_size
        noise = torch.randn((x0.shape[0] * n_data, *x0.shape[1:]),
                            generator=generator, device=x0.device,
                            dtype=x0.dtype)
        if n_data > 1:
            noise = noise.chunk(n_data)[red.data_rank]
    loss = loss_fn(x0, noise)
    loss.backward()
    clock.tick("forward+backward")
    if red is None:
        optimizer.step()
    else:
        red.reduce_grads(optimizer.params)
        optimizer.step(norm_sq=red.norm_sq)
    clock.tick("optimizer")
    state.step += 1
    return state, (loss.detach() if red is None else red.mean_loss(loss))


def _loss(dit, batch, x0, noise, attn_backend, remat, lora=None, sp=None):
    return flow_matching_loss(
        dit, x0, batch["context"], batch["rope_cos"], batch["rope_sin"],
        batch["timesteps"], noise, attn_backend=attn_backend, remat=remat,
        frame_mask=batch.get("frame_mask"), lora=lora, sp=sp)


def _mesh_parts(mesh, attn_backend, tensor_parallel=False):
    """(attention, SP context, reductions) of a step over ``mesh``: Ulysses
    and the SP context when ``seq > 1`` (``attn_backend`` its inner
    backend), the reductions when the mesh has more than one rank. With
    ``tensor_parallel`` and a model axis of more than one rank the
    attention is `make_tp_attention` (Ulysses on the local heads when
    ``seq > 1``); otherwise the model ranks repeat the step alike (JAX's
    LoRA step has no model axis)."""
    if mesh is None:
        return attn_backend, None, None
    from ..parallel import (SPContext, make_tp_attention,
                            make_ulysses_attention)
    from ..parallel.mesh import axis_size
    sp, attn = None, attn_backend
    seq = axis_size(mesh, "seq") > 1
    if seq:
        attn = make_ulysses_attention(mesh, inner_backend=attn_backend)
        sp = SPContext(mesh)
    if tensor_parallel and axis_size(mesh, "model") > 1:
        attn = make_tp_attention(mesh, seq_axis="seq" if seq else None,
                                 inner_backend=attn_backend)
    red = _MeshReduce(mesh) if mesh.size() > 1 else None
    return attn, sp, red


def make_train_step(dit: WanDiT, optimizer=None,
                    remat: Union[bool, str] = True,
                    attn_backend: Optional[str] = None, mesh=None,
                    fsdp_min_size: int = 2 ** 16
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
    unknown name raises ValueError at the first step, as in JAX).

    ``mesh``: the step over a ('data', 'seq', 'model') mesh (module
    docstring); ``batch`` and ``noise`` are then this rank's rows, and
    ``init_fn`` shards the parameters (those of at least
    ``fsdp_min_size`` elements) and so the optimizer state over ``data``
    with FSDP; over a model axis it first cuts each rank's TP shard
    (module docstring). The loss returned is the global batch's."""
    optimizer = optimizer or adamw(1e-5, weight_decay=1e-3)
    attn, sp, red = _mesh_parts(mesh, attn_backend, tensor_parallel=True)

    def init_fn() -> TrainState:
        dit.requires_grad_(True)
        if mesh is not None:
            from ..parallel import (apply_fsdp, apply_tp,
                                    tp_fsdp_param_shardings, validate_tp)
            from ..parallel.mesh import axis_size
            fsdp_dims = None
            if axis_size(mesh, "model") > 1:
                validate_tp(dit.cfg, mesh)
                dims = tp_fsdp_param_shardings(mesh, dit,
                                               min_size=fsdp_min_size)
                fsdp_dims = {n: f for n, (_, f) in dims.items()}
                apply_tp(dit, mesh)
            apply_fsdp(dit, mesh, min_size=fsdp_min_size, dims=fsdp_dims)
            if red is not None and fsdp_dims is not None:
                red.tp_sharded = frozenset(
                    id(p) for n, p in dit.named_parameters()
                    if dims[n][0] is not None)
        return TrainState(dit, optimizer(dit.parameters()))

    def step_fn(state: TrainState, batch, noise=None, generator=None,
                timings=None):
        return _run_step(
            state, state.optimizer, red,
            lambda x0, n: _loss(state.params, batch, x0, n, attn, remat,
                                sp=sp),
            batch, noise, generator, timings)

    return init_fn, step_fn


def make_lora_train_step(dit: WanDiT, optimizer=None, rank: int = 16,
                         remat: Union[bool, str] = True,
                         attn_backend: Optional[str] = None, mesh=None
                         ) -> Tuple[Callable, Callable]:
    """LoRA-adapter training over a frozen base: (init_fn, step_fn).

    The base weights are frozen (``requires_grad_(False)``), so only the
    adapters carry gradients and optimizer state; they fuse into each
    block's weights inside that block's call. ``init_fn(generator=None,
    adapters=None)`` -> `LoRATrainState` with adapters drawn from
    ``generator`` (`init_lora_adapters`) or the ``adapters`` given;
    ``step_fn`` as in `make_train_step`. With a ``mesh`` the adapters are
    replicated (their gradients reduced as the module docstring says); the
    caller may shard the frozen base over ``data`` (`parallel.apply_fsdp`,
    as `CoFTrainer` does)."""
    optimizer = optimizer or adamw(1e-4, weight_decay=0.0)
    attn, sp, red = _mesh_parts(mesh, attn_backend)

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
            state, state.optimizer, red,
            lambda x0, n: _loss(dit, batch, x0, n, attn, remat, lora, sp),
            batch, noise, generator, timings)

    return init_fn, step_fn
