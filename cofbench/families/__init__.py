"""Model families. A configuration names its family (its ``"family"`` key),
and all that a run does which depends on the model is found by that name:
``cofbench/families/<family>.py`` under the checkout's root, with the
modules it imports beside it and its plain reference under
``cofbench/reference/``. So a family, like a cell, is added as files. The
harness (`run.py`, `control.py`, `check.judge`, `window.py`, the metric
readers) reaches the model only through these functions of the module:

``load_mix(path)``: the traffic mix of a ``cofbench/traffic/`` file.
``system(config, seed, device, dtype)``: the system under test, its weights
    drawn on ``device`` from ``seed`` and built through the program's own
    constructors and converters.
``warm_up(system, config, mix, seed, device)``: the cell's shapes run once,
    on inputs of their own.
``trace_spans(system)``: the calls into the layers wrapped in
    `torch.profiler` spans named ``cof.<layer>`` (traced runs only).
``instrument(system, config, mix, seed, limits)``: keep, in the timed
    calls, what the comparison with ``limits`` (the cell's limits file)
    reads.
``unit(system, config, mix, seed, index, device, timings)``: unit of work
    ``index`` inside a ``cof.edit`` span, its inputs drawn from ``(seed,
    index)``; fills ``timings``, where given, with the stage walls the
    readers take (``step<i>`` a denoising step, ``encode+latents`` and
    ``decode`` the VAE); returns a dict on the host whose ``frames`` are
    what the user is served, floats in [0, 1].
``output_shape(config, mix)``: the shape of well-formed ``frames``.
``unit_flops(config, mix)``: the model FLOP of one unit, by layer.
``forwards(config, mix)``: the denoiser's forwards in one unit.
``attention_calls(config, mix)``: (B, Lq, Lk, N, D) of each attention call
    of one forward, B the batch (2 under classifier-free guidance).
``linear_flops(config, mix)``: the FLOP of one forward's linears.
``check(config, mix, seed, index, out, device, dtype, limits)``: {name:
    number} of unit ``index``'s products ``out`` against the plain
    reference, run after the program is freed.
``control(config, mix, seed, device, dtype, limits)``: ``sound`` and
    ``control`` (numbers as `check` gives them, of a sound unit and of the
    controls one precision below), ``edit_s`` and ``reference_s``."""

from __future__ import annotations

import hashlib
import importlib
import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(name: str, root: Path):
    """The module of family ``name`` under the checkout ``root``."""
    path = (Path(root) / "cofbench" / "families" / f"{name}.py").resolve()
    if not path.is_file():
        raise SystemExit(f"cofbench: no family {name!r} at {path}")
    if path == HERE / f"{name}.py" and name.isidentifier():
        return importlib.import_module(f"{__name__}.{name}")
    # another checkout's file: loaded once, under a name of its own
    key = "cofbench_family_" + hashlib.sha256(str(path).encode()).hexdigest()
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]
