"""Build and load the hand-written CUDA kernels.

Each source under `videocof_torch/csrc/` is compiled by `nvcc` into a shared
library with a plain C interface, at first use, into `videocof_torch/_build/`
(listed in `.gitignore`). The file name carries a hash of the source, the
shared headers (`csrc/*.cuh`) and the flags, so an edited source or header is
rebuilt and an unchanged one is loaded as is. `build_all` compiles several
sources at once, one nvcc process each.
Nothing is built when a module is imported: the CPU tests import every module
on a machine without `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_source_locks: Dict[str, threading.Lock] = {}
_loaded: Dict[str, ctypes.CDLL] = {}
# per source: {"seconds": build wall time (0.0 when loaded from the cache),
# "log": nvcc's output, including ptxas register/shared-memory report}
build_info: Dict[str, dict] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.is_file():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH); "
                           "the CUDA kernels are built on the GPU machine")
    return found


def library_path(source: str) -> Path:
    src = (CSRC / source).read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()
    return BUILD_DIR / f"lib{Path(source).stem}-{digest[:16]}.so"


def build_all(sources) -> None:
    """Compile the missing libraries of ``sources`` in parallel (one nvcc
    process each) and load them all; raises on the first failed build."""
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        for fut in [pool.submit(load, s) for s in sources]:
            fut.result()


def load(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` (if its hashed library is missing) and load
    it. Raises with nvcc's output when the build fails."""
    with _lock:
        lock = _source_locks.setdefault(source, threading.Lock())
    with lock:
        if source in _loaded:
            return _loaded[source]
        lib_path = library_path(source)
        if lib_path.is_file():
            build_info[source] = {"seconds": 0.0, "log": ""}
        else:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source}:\n{' '.join(cmd)}"
                                   f"\n{res.stdout}\n{res.stderr}")
            os.replace(tmp, lib_path)   # atomic against a concurrent build
            build_info[source] = {"seconds": time.perf_counter() - t0,
                                  "log": res.stdout + res.stderr}
        _loaded[source] = ctypes.CDLL(str(lib_path))
        return _loaded[source]
