"""Pipeline parallelism (GPipe) over the DiT block stack, on
`torch.distributed`.

Counterpart of `videocof_tpu/parallel/pp.py`: the blocks split into S
contiguous stages over a mesh axis (each rank holds ``n_layers / S``
blocks), and microbatches stream through the stages with neighbour-only
hops (`_collectives.ppermute`), the GPipe schedule of M + S - 1 ticks in
which stage s holds microbatch t - s at tick t. The last stage's outputs
reach every rank (JAX's masked ``psum``). Typical meshes repurpose the
``seq`` axis for stages: tokens are not sharded under PP.

Departures: `pp_scan_blocks` takes THIS stage's blocks (JAX's takes the
stacked tree and shards it itself), a rank skips the ticks in which it
holds no microbatch (JAX computes them and throws them away), and the
backward recomputes each tick's stage from its saved input (one autograd
Function, so that every rank runs the reverse schedule's hops in the same
order; JAX's scan keeps the residuals).
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.utils._pytree import tree_flatten, tree_unflatten

from ._collectives import _shift, _sum
from .mesh import axis_size


def pp_param_shardings(mesh: DeviceMesh, blocks, axis: str = "seq"
                       ) -> nn.ModuleList:
    """This rank's stage of ``blocks``: stage s of the ``axis`` ranks holds
    the contiguous blocks ``[s n/S, (s+1) n/S)`` (JAX's returns the
    layer-axis shardings of the stacked tree; the caller may free the
    other blocks)."""
    S, s = axis_size(mesh, axis), mesh.get_local_rank(axis)
    blocks = list(blocks)
    if len(blocks) % S:
        raise ValueError(f"{len(blocks)} layers % {S} stages != 0")
    per = len(blocks) // S
    return nn.ModuleList(blocks[s * per:(s + 1) * per])


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, x, *inputs):
        ctx.run = run
        n_cond = run.n_cond
        out, saved = run.forward(x, inputs[:n_cond])
        ctx.saved = saved
        ctx.cond = inputs[:n_cond]
        return out

    @staticmethod
    def backward(ctx, grad):
        run = ctx.run
        wants = ctx.needs_input_grad[2:2 + run.n_cond]
        gx, gcond, gparams = run.backward(grad, ctx.saved, ctx.cond, wants)
        return (None, gx, *gcond, *gparams)


class _Schedule:
    """The tick loop of one `pp_scan_blocks` call on this rank."""

    def __init__(self, group, S, idx, stage_fn, M, params, cond_spec,
                 n_cond):
        self.group, self.S, self.idx = group, S, idx
        self.stage_fn, self.M = stage_fn, M
        self.params, self.cond_spec, self.n_cond = params, cond_spec, n_cond

    def _micro(self, t: torch.Tensor) -> torch.Tensor:
        return t.reshape(self.M, t.shape[0] // self.M, *t.shape[1:])

    def _cond(self, cond_m, m):
        if self.cond_spec is None:
            return None
        return tree_unflatten([c[m] for c in cond_m], self.cond_spec)

    def forward(self, x, cond):
        S, idx, M = self.S, self.idx, self.M
        xm = self._micro(x)
        cond_m = [self._micro(c) for c in cond]
        outs = torch.zeros_like(xm)
        saved = {}
        buf = torch.zeros_like(xm[0])
        T = M + S - 1
        with torch.no_grad():
            for t in range(T):
                m = t - idx              # the microbatch this stage holds
                inp = xm[min(t, M - 1)] if idx == 0 else buf
                if 0 <= m < M:
                    saved[m] = inp
                    y = self.stage_fn(inp, self._cond(cond_m, m))
                    if idx == S - 1:
                        outs[m] = y
                else:
                    y = torch.zeros_like(inp)
                if t < T - 1:
                    buf = _shift(y, self.group, 1)
            if idx != S - 1:
                outs.zero_()
            out = _sum(outs, self.group)
        return out.reshape(x.shape), saved

    def backward(self, grad, saved, cond, wants):
        S, idx, M = self.S, self.idx, self.M
        g_out = self._micro(grad)
        cond_m = [self._micro(c) for c in cond]
        gx = torch.zeros_like(g_out)
        gcond = [torch.zeros_like(c) for c in cond_m]
        gparams = [torch.zeros_like(p) for p in self.params]
        recv = None
        for t in reversed(range(M + S - 1)):
            m = t - idx
            if 0 <= m < M:
                g_y = g_out[m] if idx == S - 1 else recv
                with torch.enable_grad():
                    inp = saved[m].detach().requires_grad_()
                    cs = [c[m].detach().requires_grad_(w)
                          for c, w in zip(cond_m, wants)]
                    y = self.stage_fn(inp, None if self.cond_spec is None
                                      else tree_unflatten(cs, self.cond_spec))
                    wrt = [inp] + [c for c in cs if c.requires_grad] \
                        + self.params
                    got = torch.autograd.grad(y, wrt, g_y, allow_unused=True)
                g_inp, got = got[0], list(got[1:])
                for i, c in enumerate(cs):
                    if c.requires_grad:
                        g = got.pop(0)
                        if g is not None:
                            gcond[i][m] += g
                for acc, g in zip(gparams, got):
                    if g is not None:
                        acc += g
                if idx == 0:
                    gx[m] = g_inp
            else:
                g_inp = torch.zeros_like(g_out[0])
            if t > 0:
                recv = _shift(g_inp, self.group, -1)
        # x and cond are replicated inputs: their gradient is every stage's
        # share, summed (stage 0 alone for x)
        gx = _sum(gx, self.group).reshape(grad.shape)
        gcond = [_sum(g, self.group).reshape(c.shape)
                 for g, c in zip(gcond, cond)]
        return gx, gcond, gparams


def pp_scan_blocks(mesh: DeviceMesh, block_fn: Callable[..., torch.Tensor],
                   stage_blocks, x: torch.Tensor, cond: Any = None,
                   microbatches: int = 1, axis: str = "seq") -> torch.Tensor:
    """What applying every block in order to ``x`` gives, run as an
    S-stage GPipe pipeline over ``axis``.

    ``block_fn(block, x, cond) -> x`` applies ONE block. ``stage_blocks``
    are this rank's blocks, in order (`pp_param_shardings`). ``cond`` is a
    pytree of tensors with a leading batch dim (e0, the text context, ...)
    microbatched with ``x``: a stage indexes the microbatch it holds.
    Batch-independent conditioning (RoPE tables) is closed over. ``x`` is
    [B, ...] with B % microbatches == 0. Every rank returns the whole
    output. Differentiable: the gradients reach ``x``, the tensors of
    ``cond`` and this stage's parameters."""
    S, idx = axis_size(mesh, axis), mesh.get_local_rank(axis)
    B = x.shape[0]
    if B % microbatches:
        raise ValueError(f"batch {B} % microbatches {microbatches} != 0")
    leaves, spec = ([], None) if cond is None else tree_flatten(cond)
    blocks = list(stage_blocks)
    params: List[torch.Tensor] = [p for blk in blocks
                                  for p in blk.parameters()
                                  if p.requires_grad]

    def stage_fn(h, c):
        for blk in blocks:
            h = block_fn(blk, h, c)
        return h

    run = _Schedule(mesh.get_group(axis), S, idx, stage_fn, microbatches,
                    params, spec, len(leaves))
    return _GPipe.apply(run, x, *leaves, *params)
