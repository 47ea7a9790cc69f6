"""The harness's tests run on the CPU at tiny sizes. The checkout's root
goes on the path so that `cofbench` and the program import; ``checkout``
is a copy of the benchmark with a tiny cell added as new files."""

import hashlib
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from cofbench.tests import tiny  # noqa: E402

NEW_METRIC = '''"""Edits completed in the window (a reader added by a test)."""


def read(w):
    return float(w.edits)
'''


def digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture(scope="session")
def checkout(tmp_path_factory):
    """A copy of BENCHMARK.json and cofbench/ with a tiny configuration, a
    tiny mix, their cell, the cell's limits and one more metric added as
    new files and entries. Returns (root, digests of the copied files
    before the addition)."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(ROOT / "cofbench", root / "cofbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = digests(root)
    bench = root / "cofbench"
    (bench / "configs" / "tiny.json").write_text(json.dumps(tiny.CONFIG))
    (bench / "traffic" / "tiny_edit.json").write_text(
        json.dumps(tiny.mix_dict()))
    (bench / "limits" / f"{tiny.CELL}.json").write_text(
        json.dumps(tiny.LIMITS))
    (bench / "metrics" / "edits_done.py").write_text(NEW_METRIC)
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny", "source": "tests",
                           "file": "cofbench/configs/tiny.json",
                           "reduced": [], "why": "CPU rehearsal"})
    man["workloads"].append({"name": tiny.CELL, "config": "tiny",
                             "traffic": "tiny_edit", "chips": 1,
                             "why": "CPU rehearsal"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(tiny.CELL)
    man["per_layer"].append({"name": "edits_done", "unit": "1",
                             "better": "higher", "source": "host_clock",
                             "layer": "whole edit", "moves": "edit_s",
                             "workloads": [tiny.CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root, before


def measure(root: Path, traced: bool, seed: int = 1234567):
    """`run.measure` of the tiny cell on the CPU under ``root``."""
    from cofbench import run
    man = json.loads((root / "BENCHMARK.json").read_text())
    return run.measure(man, tiny.CELL, seed, 0.5, traced, "cpu", root=root)
