"""The benchmark of the PyTorch and CUDA port (`videocof_torch`): one run of
one cell, on the chip it is started on.

    python3 cofbench/run.py --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>

The cell is a ``workloads`` entry of ``BENCHMARK.json``: its configuration
is ``cofbench/configs/<config>.json``, whose ``family`` names the model's
code ``cofbench/families/<family>.py``, its traffic mix
``cofbench/traffic/<traffic>.json``, each metric a reader
``cofbench/metrics/<name>.py`` and the limits of its comparison
``cofbench/limits/<cell>.json``, all found by name, so a cell, a mix, a
configuration, a family or a metric is added by adding files and entries.

A run has the family draw the weights on the card from the seed, build the
system and warm the cell's shapes up, then sends units of work (edits)
back to back for ``--seconds`` (finishing the last); with ``--trace 1``
under `torch.profiler`, the stage walls taken and the per-layer metrics
read, otherwise the end-to-end ones. Once the window has closed and the
program is freed, the family's plain reference checks one unit drawn from
the seed and the last line of standard output is the result, as JSON, the
numbers compared and their limits last. Without a card it prints no
result and exits with 3; with JAX loaded in the process, with 4.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "videocof_tpu")
DTYPES = {"bf16": "bfloat16"}


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_files(man: dict, cell: str, root: Path = ROOT):
    """(the ``workloads`` entry, its configuration, its traffic mix as its
    family reads it)."""
    from cofbench import families
    work = next((w for w in man["workloads"] if w["name"] == cell), None)
    if work is None:
        raise SystemExit(f"cofbench: no workload {cell!r} in BENCHMARK.json")
    conf = next(c for c in man["configs"] if c["name"] == work["config"])
    config = json.loads((root / conf["file"]).read_text())
    fam = families.load(config["family"], root)
    return work, config, fam.load_mix(root / "cofbench" / "traffic"
                                      / f"{work['traffic']}.json")


def readers(man: dict, section: str, cell: str, root: Path = ROOT):
    """[(metric entry, reader module)] of ``section`` that ``cell``
    reports."""
    out = []
    for m in man[section]:
        if "workloads" in m and cell not in m["workloads"]:
            continue
        path = root / "cofbench" / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(
            f"cofbench_metric_{m['name']}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out.append((m, mod))
    return out


def measure(man: dict, cell: str, seed: int, seconds: float, traced: bool,
            device, t0: float = T0, root: Path = ROOT):
    """One run of ``cell`` on ``device``, its files read under ``root``:
    (the result, the lines that give each compared number beside its
    limit)."""
    import torch

    from cofbench import check, families, inputs
    from cofbench import trace as trace_mod
    from cofbench.window import Window, closed_loop
    work, config, mix = cell_files(man, cell, root)
    fam = families.load(config["family"], root)
    dtype = getattr(torch, DTYPES[config["precision"]])
    limits = check.limits(cell, root)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    system = fam.system(config, seed, device, dtype)
    fam.warm_up(system, config, mix, seed, device)
    if traced:
        fam.trace_spans(system)
    fam.instrument(system, config, mix, seed, limits)
    sync()
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    w = Window(config, mix, setup_s=time.perf_counter() - t0, root=root)

    def one(i, timings):
        return fam.unit(system, config, mix, seed, i, device, timings)

    if traced:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            with torch.profiler.record_function("cof.window"):
                outs, w.timings, w.seconds = closed_loop(one, seconds, True,
                                                         sync)
        w.trace = trace_mod.read_profile(prof)
    else:
        outs, w.timings, w.seconds = closed_loop(one, seconds, False, sync)
    w.edits = len(outs)
    w.peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0
    w.flops = fam.unit_flops(config, mix)

    metrics = {}
    for m, mod in readers(man, "per_layer" if traced else "end_to_end",
                          cell, root):
        value = mod.read(w)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    shape = fam.output_shape(config, mix)
    failed = sum(not check.well_formed(o["frames"], shape) for o in outs)
    index = random.Random(inputs.sub_seed(seed, "sample")).randrange(
        len(outs))
    out = outs[index]
    del outs, system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    found = fam.check(config, mix, seed, index, out, device, dtype, limits)
    print(f"cofbench: set-up {w.setup_s:.3f} s, window {w.seconds:.3f} s "
          f"({w.edits} edits), reference {time.perf_counter() - t_ref:.3f} "
          f"s", file=sys.stderr, flush=True)
    ok, table = check.judge(found, limits)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": work["chips"],
           "memory_peak_bytes": max(setup_peak, w.peak_bytes)}
    result = {"correct": ok and failed == 0, "attempted": w.edits,
              "failed": failed, "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = w.trace.busy_us / 1e6
        dev["window_s"] = w.trace.window_us / 1e6
        result["breakdown"] = {
            "device_ops": [list(x) for x in w.trace.top_ops()],
            "idle_gaps": [list(x) for x in w.trace.top_gaps()]}
    result["check"] = dict(table, malformed_edits={"value": failed,
                                                   "limit": 0})
    lines = [f"cofbench check: edit {index} of {w.edits} against the "
             f"reference"]
    lines += [f"cofbench check: {k} {v['value']} (limit {v['limit']})"
              for k, v in table.items()]
    lines.append(f"cofbench check: malformed_edits {failed} (limit 0)")
    return result, lines


def card_note() -> str:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi not found"
    res = subprocess.run([smi, "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip() or res.stderr.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    os.environ.pop("VIDEOCOF_ATTENTION_TYPE", None)
    os.environ.pop("VIDEOCOF_TIMING", None)
    man = manifest()
    work = next((w for w in man["workloads"]
                 if w["name"] == args.workload), None)
    if work is None:
        print(f"cofbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < work["chips"]:
        print(f"cofbench: {args.workload} needs {work['chips']} CUDA "
              f"device(s); found {found}; no result", file=sys.stderr)
        return 3
    print(f"cofbench: card {card_note()}", file=sys.stderr, flush=True)
    result, lines = measure(man, args.workload, args.seed, args.seconds,
                            bool(args.trace), torch.device("cuda"))
    bad = forbidden_modules()
    if bad:
        print(f"cofbench: the run's process loaded {bad}; no result",
              file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    print(f"cofbench check: correct {str(result['correct']).lower()}",
          file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
