#!/usr/bin/env python3
"""Time kernel B4's K pre-pass of one checkout of the PyTorch port on one
NVIDIA GPU, at the standard edit's two B4 shapes (batched CFG, 12 heads of
128, bf16): self-attention, K [2, 29,640, 12, 128], and cross-attention, K
[2, 512, 12, 128].

    python3 scripts/k_prepass_ab.py --root DIR --tag NAME --out FILE

``DIR`` is the root of a checkout (this repository, or an unpacked `git
archive` of another commit); its `videocof_torch` is imported and its
kernels are built there. Both forms of the pre-pass are timed:

* ``int8_quantize_k(k)``, which takes K's mean itself (one launch);
* ``int8_quantize_k(k, mean)`` after ``k_mean(k)``, a torch reduction over
  K (the form before the mean moved into the kernel): the pair, and
  ``k_mean`` alone.

Each is timed three ways, with `chip_smoke.py`'s helpers (taken from this
script's own repository, whatever ``DIR`` is): CUDA events around one call
(the host's launch overhead included, as `chip_smoke.py` phase 3 times),
events around 50 calls back to back (the device's rate where it outruns
the host), and the device time of its kernels under torch.profiler. B4's
whole call (``int8_flash_attention``) is timed the first two ways. The
bounds are `chip_smoke.int8_bounds`'s: the pre-pass reads K once, the pair
reads it twice. One JSON line a shape is appended to ``FILE``, with the
card's name and power limit. To compare two checkouts, run them in turns
in one session on one card (A, B, B, A).
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

SHAPES = {"self": (2, 29640, 12, 128), "cross": (2, 512, 12, 128)}
LQ = 29640                    # the standard edit's query tokens


def _chip_smoke():
    """This repository's `chip_smoke.py` as a module (it imports nothing
    but the standard library at import time)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, type=Path)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--out", required=True, type=Path)
    args = ap.parse_args()
    cs = _chip_smoke()
    sys.path.insert(0, str(args.root.resolve()))
    import torch
    if not torch.cuda.is_available():
        sys.exit("k_prepass_ab: no CUDA device")
    from videocof_torch.ops import int8_attention as i8
    i8._library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    takes_mean = "mean" in inspect.signature(i8.int8_quantize_k).parameters
    gen = torch.Generator(device="cuda").manual_seed(0)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    for shape_name, (B, Lk, N, D) in SHAPES.items():
        k, v = (torch.randn(B, Lk, N, D, generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        q = torch.randn(B, LQ, N, D, generator=gen, device="cuda").to(
            torch.bfloat16)
        bounds = cs.int8_bounds(B, LQ, Lk, N, D)
        rec = {"tag": args.tag, "card": card, "shape": shape_name,
               "k_shape": [B, Lk, N, D],
               "bound_ms": bounds["int8_quantize_k"][0],
               "pair_bound_ms": bounds["k_mean + quantize"][0],
               "takes_mean": takes_mean}
        forms = {"k_mean": lambda: i8.k_mean(k)}
        if takes_mean:
            mean = i8.k_mean(k)
            forms["pre_pass_given_mean"] = lambda: i8.int8_quantize_k(k, mean)
            forms["pair"] = lambda: i8.int8_quantize_k(k, i8.k_mean(k))
        else:
            forms["pre_pass"] = lambda: i8.int8_quantize_k(k)
        forms["b4_whole"] = lambda: i8.int8_flash_attention(q, k, v)
        for name, fn in forms.items():
            calls = 50 if name != "b4_whole" else 3

            def back_to_back(fn=fn, calls=calls):
                for _ in range(calls):
                    fn()

            rec[name] = {"one_call_ms": cs.cuda_ms(fn, runs=20),
                         "back_to_back_ms": cs.cuda_ms(back_to_back,
                                                       runs=10) / calls}
            if name != "b4_whole":
                fn()
                torch.cuda.synchronize()
                _, _, prof = cs.profile_kernels(
                    lambda fn=fn: [fn() for _ in range(20)])
                rec[name]["device_ms"] = sum(ms for ms, _, _ in prof) / 20
                rec[name]["device_kernels"] = {
                    name_k: ms / 20 for ms, _, name_k in prof}
        print(json.dumps(rec), flush=True)
        with args.out.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        del k, v, q
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
