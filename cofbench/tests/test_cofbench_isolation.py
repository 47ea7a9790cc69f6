"""Nothing under cofbench/ imports JAX or the JAX package (top-level module
names compared whole: the port's name begins with the JAX package's), the
reference imports nothing of the program, and no file reads the JAX
package's own benchmark or its result files."""

from __future__ import annotations

import ast
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "videocof" + "_tpu"}
PROGRAM = "videocof" + "_torch"
# the JAX package's benchmark script and its result files
OLD_BENCH = re.compile(r"(?<![\w/])bench\.py|BENCH_\w*\.json|MULTICHIP_")


def _imports(path: Path):
    """Top-level names of every module ``path`` imports."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    return sorted(p for p in BENCH.rglob("*.py")
                  if "__pycache__" not in p.parts)


def test_no_module_imports_jax_or_the_jax_package():
    bad = {str(p.relative_to(BENCH)): sorted(set(_imports(p)) & FORBIDDEN)
           for p in _sources()}
    assert not {k: v for k, v in bad.items() if v}


def test_the_reference_imports_nothing_of_the_program():
    ref = [p for p in _sources() if "reference" in p.parts]
    assert ref
    for p in ref:
        assert PROGRAM not in set(_imports(p)), p
        assert PROGRAM not in p.read_text(), p


def test_nothing_reads_the_jax_benchmark():
    hits = [str(p.relative_to(BENCH)) for p in BENCH.rglob("*")
            if p.is_file() and p.suffix in (".py", ".json", ".sh", ".txt")
            and p != Path(__file__) and OLD_BENCH.search(p.read_text())]
    assert not hits
