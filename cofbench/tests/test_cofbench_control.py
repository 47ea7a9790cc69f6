"""The comparison that decides ``correct``, shown to fail: at the tiny
presets on the CPU, each number's control one precision below the
configuration's bf16 (the program's fp8 weight storage for the DiT and the
whole edit; the reference with fp8 operands for umT5 and the VAE) fails
the tiny cell's limit on every seed, and the harness's judge reads the
controls incorrect, where the sound bf16 run passes them all; and a run
driven whole with the timed path broken underneath (a sampler step that
returns its state unchanged; an answer altered where the pipeline produces
it) reads ``correct`` false; all of it again for the cell held by the
one-step check, whose sampler replay (``sampler_rel_l2``) catches the
frozen step. The same control runs on the chip at the cells' own sizes
through ``cofbench/control.py``."""

from __future__ import annotations

import pytest

from cofbench import control
from cofbench.families import wan_program as program
from cofbench.tests import tiny
from cofbench.tests.conftest import measure


@pytest.mark.parametrize("seed", [3100000001, 3100000002, 3100000003])
def test_each_control_fails_where_the_sound_run_passes(checkout, seed):
    root, _ = checkout
    r = control.readings(tiny.CELL, seed, "cpu", root=root)
    assert r["sound_correct"] and not r["control_correct"], r
    assert set(r["control"]) == set(tiny.LIMITS)
    for name, limit in tiny.LIMITS.items():
        assert r["control"][name] > limit, (name, r)


def _frozen(pipe):
    real = pipe._scheduler

    def scheduler(*args, **kw):
        sched = real(*args, **kw)
        sched.step = lambda v, i, x, state: (x, state)
        return sched
    pipe._scheduler = scheduler


def _altered(pipe):
    real = pipe._decode_outputs

    def decode(*args, **kw):
        out = real(*args, **kw)
        out.videos[:, :, -1] = 0.5
        return out
    pipe._decode_outputs = decode


@pytest.mark.parametrize("fault", [_frozen, _altered])
def test_a_broken_timed_path_reads_incorrect(checkout, monkeypatch, fault):
    root, _ = checkout
    real_build = program.build

    def build(*args, **kw):
        pipe = real_build(*args, **kw)
        fault(pipe)
        return pipe
    monkeypatch.setattr(program, "build", build)
    result, lines = measure(root, traced=False, seed=3100000009)
    assert result["correct"] is False, result["check"]
    assert result["failed"] == 0      # well-formed answers, wrong ones


@pytest.mark.parametrize("seed", [3100000011, 3100000012, 3100000013])
def test_each_control_fails_under_the_step_check(checkout, seed):
    root, _ = checkout
    r = control.readings(tiny.STEP_CELL, seed, "cpu", root=root)
    assert r["sound_correct"] and not r["control_correct"], r
    assert set(r["control"]) == set(tiny.STEP_LIMITS)
    for name, limit in tiny.STEP_LIMITS.items():
        assert r["control"][name] > limit, (name, r)


@pytest.mark.parametrize("fault", [_frozen, _altered])
def test_a_broken_timed_path_reads_incorrect_under_the_step_check(
        checkout, monkeypatch, fault):
    root, _ = checkout
    real_build = program.build

    def build(*args, **kw):
        pipe = real_build(*args, **kw)
        fault(pipe)
        return pipe
    monkeypatch.setattr(program, "build", build)
    result, _ = measure(root, traced=False, seed=3100000019,
                        cell=tiny.STEP_CELL)
    assert result["correct"] is False, result["check"]
    assert result["failed"] == 0
