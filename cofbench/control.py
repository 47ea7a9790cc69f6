"""The readings that the limits of `cofbench/limits/<cell>.json` are set
from, at the cell's own size on the chip:

    python3 cofbench/control.py --workload <cell> --seeds 11 12 13

For each seed, the cell's family (its ``control``) runs unit 0 of the
cell's mix as a run builds it, in the configuration's precision: a sound
run, whose numbers are lower readings; then the controls, one precision
below, each in place of the stage a number checks, whose numbers are
upper readings (for Wan: the program's own fp8 DiT, and the reference with
fp8 operands where the program has no fp8 path). Both sets go through the
harness's own judge (`check.judge`) against the cell's limits:
``sound_correct`` has to read true and ``control_correct`` false. One JSON
line a seed."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell: str, seed: int, device, root: Path = ROOT) -> dict:
    """The sound run's numbers and the controls' on one seed."""
    import torch

    from cofbench import check, families, run
    _, config, mix = run.cell_files(run.manifest(root), cell, root)
    fam = families.load(config["family"], root)
    dtype = getattr(torch, run.DTYPES[config["precision"]])
    limits = check.limits(cell, root)
    r = fam.control(config, mix, seed, device, dtype, limits)
    return {"cell": cell, "seed": seed, "sound": r["sound"],
            "control": r["control"],
            "sound_correct": check.judge(r["sound"], limits)[0],
            "control_correct": check.judge(r["control"], limits)[0],
            "edit_s": r["edit_s"], "reference_s": r["reference_s"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed,
                                  torch.device("cuda"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
