"""A toy family for the harness's CPU tests, added to a copy of the
checkout as ``cofbench/families/toy.py`` with a configuration, a mix and a
cell of its own: a unit is ``steps`` multi-head attention calls of the
program (`videocof_torch.ops.attention`, its plain backend) on inputs drawn
from the seed, the answer the last call's output (in [0, 1], as the values
are), held against a float64 softmax attention written here."""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from cofbench.check import rel
from cofbench.inputs import sub_seed

CONFIG = {"name": "toy", "precision": "bf16", "family": "toy", "heads": 2,
          "head_dim": 8}
MIX = {"tokens": 64, "steps": 2}
CELL = "toy.attend"
# float64 against the program's bf16 reads 1.8e-3 on three seeds, fp8
# operands 7.2e-3 to 7.8e-3
LIMITS = {"toy_rel_l2": 0.004}


@dataclass(frozen=True)
class Mix:
    name: str
    tokens: int
    steps: int


@dataclass
class System:
    attend: object
    dtype: torch.dtype


def load_mix(path):
    raw = json.loads(Path(path).read_text())
    return Mix(Path(path).stem, raw["tokens"], raw["steps"])


def system(config, seed, device, dtype):
    from videocof_torch.ops.attention import attention
    return System(lambda q, k, v: attention(q, k, v, backend="naive"), dtype)


def _inputs(config, mix, seed, index, device, dtype):
    gen = torch.Generator(device=device).manual_seed(
        sub_seed(seed, "toy", index))
    shape = (1, mix.tokens, config["heads"], config["head_dim"])
    q = torch.randn(shape, generator=gen, device=device)
    k = torch.randn(shape, generator=gen, device=device)
    v = torch.rand(shape, generator=gen, device=device)
    return [a.to(dtype) for a in (q, k, v)]


def warm_up(s, config, mix, seed, device):
    unit(s, config, mix, seed, -1, device)


def trace_spans(s):
    real = s.attend

    def attend(*args):
        with torch.profiler.record_function("cof.dit"):
            return real(*args)
    s.attend = attend


def instrument(s, config, mix, seed, limits):
    pass


def unit(s, config, mix, seed, index, device, timings=None):
    q, k, v = _inputs(config, mix, seed, index, device, s.dtype)
    with torch.profiler.record_function("cof.edit"):
        for i in range(mix.steps):
            t0 = time.perf_counter()
            out = s.attend(q, k, v)
            if timings is not None:
                timings[f"step{i}"] = time.perf_counter() - t0
    return {"frames": out.float().cpu()}


def output_shape(config, mix):
    return (1, mix.tokens, config["heads"], config["head_dim"])


def forwards(config, mix):
    return mix.steps


def attention_calls(config, mix):
    return [(1, mix.tokens, mix.tokens, config["heads"], config["head_dim"])]


def linear_flops(config, mix):
    return 0.0


def unit_flops(config, mix):
    L, N, D = mix.tokens, config["heads"], config["head_dim"]
    return {"attention": 4.0 * mix.steps * L * L * N * D}


def reference(q, k, v, quant=lambda t: t):
    q, k, v = (quant(a.double()) for a in (q, k, v))
    logits = torch.einsum("blnd,bmnd->bnlm", q, k) * q.shape[-1] ** -0.5
    return torch.einsum("bnlm,bmnd->blnd", logits.softmax(-1), v)


def check(config, mix, seed, index, out, device, dtype, limits):
    q, k, v = _inputs(config, mix, seed, index, device, dtype)
    return {"toy_rel_l2": rel(out["frames"], reference(q, k, v).cpu())}


def control(config, mix, seed, device, dtype, limits):
    s = system(config, seed, device, dtype)
    t0 = time.perf_counter()
    sound = unit(s, config, mix, seed, 0, device)
    t1 = time.perf_counter()
    q, k, v = _inputs(config, mix, seed, 0, device, dtype)

    def fp8(t):
        return t.to(torch.float8_e4m3fn).double()
    low = {"frames": reference(q, k, v, fp8).cpu()}
    return {"sound": check(config, mix, seed, 0, sound, device, dtype,
                           limits),
            "control": check(config, mix, seed, 0, low, device, dtype,
                             limits),
            "edit_s": t1 - t0, "reference_s": time.perf_counter() - t1}
