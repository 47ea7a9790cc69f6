"""The harness's tests run on the CPU at tiny sizes. The checkout's root
goes on the path so that `cofbench` and the program import; ``checkout``
is a copy of the benchmark with two tiny cells added as new files, and
``toy_checkout`` one with a family of its own added so."""

import hashlib
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from cofbench.tests import tiny, toy  # noqa: E402

NEW_METRIC = '''"""Edits completed in the window (a reader added by a test)."""


def read(w):
    return float(w.edits)
'''


def digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def _copy(tmp_path_factory, name):
    """A copy of BENCHMARK.json and cofbench/ (its tests left out), and the
    digests of its files."""
    root = tmp_path_factory.mktemp(name)
    shutil.copytree(ROOT / "cofbench", root / "cofbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root, digests(root)


def _add_cell(man, cell, config, traffic):
    man["workloads"].append({"name": cell, "config": config,
                             "traffic": traffic, "chips": 1,
                             "why": "CPU rehearsal"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(cell)


@pytest.fixture(scope="session")
def checkout(tmp_path_factory):
    """A copy of BENCHMARK.json and cofbench/ with a tiny configuration,
    two tiny mixes (the second held by the one-step check), their cells,
    the cells' limits and one more metric added as new files and entries.
    Returns (root, digests of the copied files before the addition)."""
    root, before = _copy(tmp_path_factory, "checkout")
    bench = root / "cofbench"
    (bench / "configs" / "tiny.json").write_text(json.dumps(tiny.CONFIG))
    (bench / "traffic" / "tiny_edit.json").write_text(
        json.dumps(tiny.mix_dict()))
    (bench / "traffic" / "tiny4x_edit.json").write_text(
        json.dumps(tiny.mix_dict(**tiny.STEP_MIX)))
    (bench / "limits" / f"{tiny.CELL}.json").write_text(
        json.dumps(tiny.LIMITS))
    (bench / "limits" / f"{tiny.STEP_CELL}.json").write_text(
        json.dumps(tiny.STEP_LIMITS))
    (bench / "metrics" / "edits_done.py").write_text(NEW_METRIC)
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny", "source": "tests",
                           "file": "cofbench/configs/tiny.json",
                           "reduced": [], "why": "CPU rehearsal"})
    _add_cell(man, tiny.CELL, "tiny", "tiny_edit")
    _add_cell(man, tiny.STEP_CELL, "tiny", "tiny4x_edit")
    man["per_layer"].append({"name": "edits_done", "unit": "1",
                             "better": "higher", "source": "host_clock",
                             "layer": "whole edit", "moves": "edit_s",
                             "workloads": [tiny.CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root, before


@pytest.fixture(scope="session")
def toy_checkout(tmp_path_factory):
    """A copy of BENCHMARK.json and cofbench/ with a second family
    (`cofbench.tests.toy`), a configuration and a mix of it, its cell and
    the cell's limits added as new files and entries. Returns (root,
    digests of the copied files before the addition)."""
    root, before = _copy(tmp_path_factory, "toy_checkout")
    bench = root / "cofbench"
    shutil.copy(ROOT / "cofbench" / "tests" / "toy.py",
                bench / "families" / "toy.py")
    (bench / "configs" / "toy.json").write_text(json.dumps(toy.CONFIG))
    (bench / "traffic" / "toy_attend.json").write_text(json.dumps(toy.MIX))
    (bench / "limits" / f"{toy.CELL}.json").write_text(
        json.dumps(toy.LIMITS))
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "toy", "source": "tests",
                           "file": "cofbench/configs/toy.json",
                           "reduced": [], "why": "CPU rehearsal"})
    _add_cell(man, toy.CELL, "toy", "toy_attend")
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root, before


def measure(root: Path, traced: bool, seed: int = 1234567,
            cell: str = tiny.CELL):
    """`run.measure` of a tiny cell on the CPU under ``root``."""
    from cofbench import run
    man = json.loads((root / "BENCHMARK.json").read_text())
    return run.measure(man, cell, seed, 0.5, traced, "cpu", root=root)
