"""The readings that the limits of `cofbench/limits/<cell>.json` are set
from, at the cell's own size on the chip:

    python3 cofbench/control.py --workload <cell> --seeds 11 12 13

For each seed, edit 0 of the cell's mix through the pipeline as a run
builds it, in the configuration's precision (bf16): a sound run, whose
numbers are lower readings. Then the controls, one precision below (fp8),
each in place of the stage a number checks: the program's own fp8 weight
storage for the DiT (``latent_rel_l2``), and, where the program has no
fp8 path, the reference computed with both operands of every linear or
convolution rounded to fp8 e4m3: umT5 (``text_rel_l2``), the VAE's encode
(``source_rel_l2``) and decode (``frame_rms``), and, where the cell's
limits hold it, the whole edit (``edit_rel_l2``: umT5, the encode and the
DiT's trajectory all so rounded). Their numbers are upper readings. Both
sets go through the harness's own judge (`check.judge`) against the
cell's limits: ``sound_correct`` has to read true and ``control_correct``
false. One JSON line a seed."""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell: str, seed: int, device, root: Path = ROOT) -> dict:
    """The sound run's numbers and the controls' on one seed."""
    import torch

    from cofbench import check, inputs, program, run
    from cofbench.reference import edit as R
    _, config, mix = run.cell_files(run.manifest(root), cell, root)
    dtype = getattr(torch, run.DTYPES[config["precision"]])
    pipe = program.build(config, inputs.dit_weights(config, seed, device,
                                                    dtype),
                         inputs.vae_weights(config, seed, device, dtype),
                         inputs.t5_weights(config, seed, device, dtype),
                         inputs.lora_files(config, seed, device, dtype),
                         device, dtype)
    texts = program.keep_text(pipe)
    e = mix.edit(seed, 0, config["vae"]["z_dim"], device)
    t0 = time.perf_counter()
    sound = program.edit(pipe, mix, e) + (texts[-1].float().cpu(),)
    t1 = time.perf_counter()
    program.quantize_fp8(pipe)
    low = program.edit(pipe, mix, e) + (texts[-1].float().cpu(),)
    del pipe, texts
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    src = mix.latent_grid()[0]
    limits = check.limits(cell, root)
    whole = "edit_rel_l2" in limits
    t2 = time.perf_counter()
    ref = R.check_products(config, mix, seed, 0, sound[2], sound[1], device,
                           dtype, whole=whole)
    t3 = time.perf_counter()
    prog = dict(zip(("frames", "latents", "context"), sound))
    same_start = (torch.equal(low[2], sound[2])
                  and np.array_equal(low[1][:, :, :src], sound[1][:, :, :src]))
    low_ref = ref if same_start else R.check_products(
        config, mix, seed, 0, low[2], low[1], device, dtype, whole=whole)
    with torch.no_grad():
        ctx8 = R.encode_text(config, e["prompt"], mix.text_len, seed, device,
                             dtype, quant=R.fp8).cpu()
        W8 = R.vae_weights(config, seed, device, dtype, quant=R.fp8)
        mu8 = R.encode_clip(W8, config, e["clip"]).cpu()
        lat = torch.as_tensor(sound[1], device=device)
        ground = mix.latent_grid()[1]
        frames8 = R.decode(W8, config, lat, src, ground).cpu()
        if whole:
            start = torch.cat([mu8.to(device), e["noise"]], dim=2)
            whole8, = R.denoise(config, mix, seed, [(start, ctx8.to(device))],
                                src, ground, device, dtype, quant=R.fp8)
    control = {
        "text_rel_l2": check.rel(ctx8, ref["context"]),
        "source_rel_l2": check.rel(mu8, ref["source"]),
        "latent_rel_l2": check.numbers(
            dict(zip(("frames", "latents", "context"), low)), low_ref,
            src)["latent_rel_l2"],
        "frame_rms": check.numbers(dict(prog, frames=frames8.numpy() / 255.0),
                                   ref, src)["frame_rms"]}
    if whole:
        control["edit_rel_l2"] = check.rel(whole8[:, :, src:].cpu(),
                                           ref["whole"][:, :, src:])
    found = check.numbers(prog, ref, src)
    return {"cell": cell, "seed": seed, "sound": found, "control": control,
            "sound_correct": check.judge(found, limits)[0],
            "control_correct": check.judge(control, limits)[0],
            "edit_s": t1 - t0, "reference_s": t3 - t2}


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
