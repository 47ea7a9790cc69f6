"""The family ``wan``: the Wan2.1 text-to-video DiTs, run as VideoCoF's
chain-of-frames edit by `videocof_torch`'s `WanPipeline` (`wan_program`),
their weights drawn in the published layouts (`wan_layouts`), the edits of
a mix (`wan_mix`), their FLOP (`wan_yardstick`) and the float32 reference
(`cofbench/reference/`).

A cell's limits file chooses the check. By default the whole trajectory
is held (``latent_rel_l2``; ``edit_rel_l2`` adds the reference's own
edit). Where the limits name ``step_rel_l2`` (a clip whose float32
trajectory would not fit a run), each timed edit leaves host copies of
every velocity its DiT returned and of the inputs of one step drawn from
the seed; the check holds that step against one float32 forward
(``step_rel_l2``) and the sampler replayed over the program's velocities
(``sampler_rel_l2``), with the streamed reference VAE."""

from __future__ import annotations

import gc
import random
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from cofbench.check import rel
from cofbench.families import wan_layouts as layouts
from cofbench.families import wan_mix
from cofbench.families import wan_program as program
from cofbench.families import wan_yardstick as yardstick
from cofbench.inputs import sub_seed

# the limit whose presence asks for the one-step check
STEP_CHECK = "step_rel_l2"


@dataclass
class System:
    pipe: object
    texts: list = field(default_factory=list)
    calls: Optional[program.DiTCalls] = None


def load_mix(path):
    return wan_mix.Mix.load(path)


def system(config: dict, seed: int, device, dtype) -> System:
    return System(program.build(
        config, layouts.dit_weights(config, seed, device, dtype),
        layouts.vae_weights(config, seed, device, dtype),
        layouts.t5_weights(config, seed, device, dtype),
        layouts.lora_files(config, seed, device, dtype), device, dtype))


def warm_up(s: System, config: dict, mix, seed: int, device) -> None:
    """A one-step edit of inputs of its own."""
    program.edit(s.pipe, mix, mix.edit(seed, -1, config["vae"]["z_dim"],
                                       device), steps=1)


def trace_spans(s: System) -> None:
    program.trace_spans(s.pipe)


def instrument(s: System, config: dict, mix, seed: int, limits) -> None:
    s.texts = program.keep_text(s.pipe)
    if STEP_CHECK in limits:
        s.calls = program.capture_dit(s.pipe)


def kept_step(mix, seed: int, index: int) -> int:
    """The step of edit ``index`` whose DiT inputs the check keeps."""
    return random.Random(sub_seed(seed, "step", index)).randrange(mix.steps)


def unit(s: System, config: dict, mix, seed: int, index: int, device,
         timings=None) -> dict:
    """Edit ``index``: ``frames`` (float32 in [0, 1], [1, 3, T, H, W]),
    ``latents`` (the final ones), ``context`` (the prompt embeddings) and,
    under the one-step check, ``dit`` (`DiTCalls.take`), on the host."""
    e = mix.edit(seed, index, config["vae"]["z_dim"], device)
    if s.calls is not None:
        s.calls.start(kept_step(mix, seed, index))
    with torch.profiler.record_function("cof.edit"):
        frames, latents = program.edit(s.pipe, mix, e, timings)
    # the embedding goes to the host, so that the card holds none of the
    # harness's past the call and the peak is the program's own
    out = {"frames": frames, "latents": latents,
           "context": s.texts.pop().cpu()}
    if s.calls is not None:
        out["dit"] = s.calls.take()
    return out


def output_shape(config: dict, mix) -> tuple:
    src, ground, _, _, _ = mix.latent_grid()
    pixel = lambda n: 1 + (n - 1) * 4     # noqa: E731
    return (1, 3, pixel(ground) + pixel(src), mix.height, mix.width)


def batch(mix) -> int:
    """Rows of a DiT forward: 2 under classifier-free guidance."""
    return 2 if mix.guidance_scale > 1.0 else 1


def forwards(config: dict, mix) -> int:
    return mix.steps


def attention_calls(config: dict, mix) -> list:
    cfg = config["dit"]
    calls = yardstick.attention_calls(cfg, mix.tokens(cfg["patch_size"]),
                                      mix.text_len)
    return [(batch(mix),) + c[1:] for c in calls]


def linear_flops(config: dict, mix) -> float:
    cfg = config["dit"]
    return batch(mix) * yardstick.dit_linear_flops(
        cfg, mix.tokens(cfg["patch_size"]), mix.text_len)


def unit_flops(config: dict, mix) -> Dict[str, float]:
    out = yardstick.edit_flops(config, mix)
    out["dit"] *= batch(mix)
    return out


def numbers(prog: dict, ref: dict, source: int) -> Dict[str, float]:
    """The program's products (``context``: its prompt embeddings;
    ``latents``: its final latents; ``frames``: its served frames, [0, 1]
    floats; ``dit``: its DiT's calls) against the reference's:

    ``text_rel_l2``: relative L2 distance of the prompt embeddings (umT5).
    ``source_rel_l2``: of the ``source`` frozen latent frames, the VAE's
    encode of the clip. ``latent_rel_l2``: of the latents after them, the
    reasoning and edit frames the sampler made, against the reference's
    trajectory from the program's source latents and embeddings (the DiT,
    RoPE, B1 and the sampler). ``frame_rms``: root mean square of the
    served frames on their uint8 levels minus the reference's decode of
    the program's final latents, in levels (the VAE's decode). Where
    ``ref`` holds ``whole``, the reference's own edit, also
    ``edit_rel_l2``: of the latents after the source frames against it
    (the whole edit, umT5 and the VAE's encode included). Where it holds
    ``replay`` (the one-step check), ``step_rel_l2``, of the velocity of
    the kept step against the reference's forward on that step's inputs
    (the DiT, RoPE with RIFLEx, B1), and ``sampler_rel_l2``, of the latents
    after the source frames against the sampler replayed over the
    program's velocities, in place of ``latent_rel_l2``."""
    lat = np.asarray(prog["latents"], np.float64)
    got = np.rint(np.asarray(prog["frames"], np.float64) * 255.0)
    want = np.asarray(ref["frames"], np.float64)
    out = {"text_rel_l2": rel(prog["context"], ref["context"]),
           "source_rel_l2": rel(lat[:, :, :source], ref["source"])}
    if "latents" in ref:
        out["latent_rel_l2"] = rel(lat[:, :, source:],
                                   np.asarray(ref["latents"])[:, :, source:])
    if "replay" in ref:
        v, k = prog["dit"]["velocity"], prog["dit"]["keep"]
        out["step_rel_l2"] = (rel(v[k].float(), ref["step"])
                              if "step" in ref and k < len(v)
                              else float("inf"))
        out["sampler_rel_l2"] = rel(lat[:, :, source:],
                                    np.asarray(ref["replay"])[:, :, source:])
    out["frame_rms"] = (float(np.sqrt(np.mean((got - want) ** 2)))
                        if got.shape == want.shape else float("inf"))
    if "whole" in ref:
        out["edit_rel_l2"] = rel(lat[:, :, source:],
                                 np.asarray(ref["whole"])[:, :, source:])
    return out


def check(config: dict, mix, seed: int, index: int, out: dict, device,
          dtype, limits) -> Dict[str, float]:
    from cofbench.reference import edit as reference
    context = out["context"].float()
    if STEP_CHECK in limits:
        ref = reference.step_products(config, mix, seed, index, context,
                                      out["latents"], out["dit"], device,
                                      dtype)
    else:
        ref = reference.check_products(config, mix, seed, index, context,
                                       out["latents"], device, dtype,
                                       whole="edit_rel_l2" in limits)
    return numbers(dict(out, context=context), ref, mix.latent_grid()[0])


@torch.no_grad()
def control(config: dict, mix, seed: int, device, dtype, limits) -> dict:
    """Edit 0 of ``mix`` built as a run builds it, in the configuration's
    precision (bf16): the sound numbers. Then the controls, one precision
    below (fp8), each in place of the stage a number checks: the program's
    own fp8 weight storage for the DiT (``latent_rel_l2``, or
    ``step_rel_l2``), and, where the program has no fp8 path, the
    reference computed with both operands of every linear or convolution
    rounded to fp8 e4m3: umT5 (``text_rel_l2``), the VAE's encode
    (``source_rel_l2``) and decode (``frame_rms``), the sampler's state
    after each step (``sampler_rel_l2``) and, where the limits hold it, the
    whole edit (``edit_rel_l2``: umT5, the encode and the DiT's trajectory
    all so rounded)."""
    from cofbench.reference import edit as R
    one_step = STEP_CHECK in limits
    whole = "edit_rel_l2" in limits
    s = system(config, seed, device, dtype)
    instrument(s, config, mix, seed, limits)
    t0 = time.perf_counter()
    sound = unit(s, config, mix, seed, 0, device)
    t1 = time.perf_counter()
    program.quantize_fp8(s.pipe)
    low = unit(s, config, mix, seed, 0, device)
    del s
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    src, ground = mix.latent_grid()[:2]
    sound["context"] = sound["context"].float()
    low["context"] = low["context"].float()
    t2 = time.perf_counter()
    if one_step:
        ref = R.step_products(config, mix, seed, 0, sound["context"],
                              sound["latents"], sound["dit"], device, dtype)
    else:
        ref = R.check_products(config, mix, seed, 0, sound["context"],
                               sound["latents"], device, dtype, whole=whole)
    t3 = time.perf_counter()
    same_start = (torch.equal(low["context"], sound["context"])
                  and np.array_equal(low["latents"][:, :, :src],
                                     sound["latents"][:, :, :src]))
    if one_step:
        taken, mine = low["dit"]["inputs"], sound["dit"]["inputs"]
        same = same_start and taken is not None and mine is not None and all(
            torch.equal(taken[k], mine[k]) for k in taken)
        low_ref = ref if same or taken is None else dict(ref, step=R.step(
            config, mix, seed, taken, src, ground, device, dtype).cpu())
    else:
        low_ref = ref if same_start else R.check_products(
            config, mix, seed, 0, low["context"], low["latents"], device,
            dtype, whole=whole)
    e = mix.edit(seed, 0, config["vae"]["z_dim"], device)
    ctx8 = R.encode_text(config, e["prompt"], mix.text_len, seed, device,
                         dtype, quant=R.fp8).cpu()
    W8 = R.vae_weights(config, seed, device, dtype, quant=R.fp8)
    mu8 = R.encode_clip(W8, config, e["clip"], streamed=one_step).cpu()
    lat = torch.as_tensor(sound["latents"], device=device)
    frames8 = R.decode(W8, config, lat, src, ground, streamed=one_step).cpu()
    control = {"text_rel_l2": rel(ctx8, ref["context"]),
               "source_rel_l2": rel(mu8, ref["source"])}
    lows = numbers(low, low_ref, src)
    if one_step:
        start = torch.cat([lat[:, :, :src], e["noise"]], dim=2)
        replay8 = R.replay(mix, start, sound["dit"]["velocity"], src, device,
                           quant=R.fp8).cpu()
        control["step_rel_l2"] = lows["step_rel_l2"]
        control["sampler_rel_l2"] = rel(replay8[:, :, src:],
                                        ref["replay"][:, :, src:])
    else:
        control["latent_rel_l2"] = lows["latent_rel_l2"]
    control["frame_rms"] = numbers(dict(sound, frames=frames8.numpy() / 255.0),
                                   ref, src)["frame_rms"]
    if whole:
        start = torch.cat([mu8.to(device), e["noise"]], dim=2)
        whole8, = R.denoise(config, mix, seed, [(start, ctx8.to(device))],
                            src, ground, device, dtype, quant=R.fp8)
        control["edit_rel_l2"] = rel(whole8[:, :, src:].cpu(),
                                     ref["whole"][:, :, src:])
    return {"sound": numbers(sound, ref, src), "control": control,
            "edit_s": t1 - t0, "reference_s": t3 - t2}
