"""The reference's chain-of-frames edit, in float32 with TF32 off, by
stages: the instruction through the tokenizer and umT5 (embeddings zeroed
past its length), the source clip through the VAE encoder, the sampler's
trajectory from [source mean | noise] (every Flow-UniPC step one DiT
forward with repeat-RoPE, RIFLEx where the mix asks, the LoRA merged, the
source frozen), and the reasoning and edit segments decoded apart to uint8.

`check_products` computes what a run's sampled edit is held to: each stage
by itself, the trajectory started from the program's own source latents
and prompt embeddings (what its timed call produced), so that the umT5
stage's bf16 rounding, which is larger than the DiT's, does not hide the
DiT's; with ``whole``, the reference's own edit beside it, to hold the
program's whole edit. `step_products` holds a long clip's edit, whose
float32 trajectory would not fit a run, stage by stage on the streamed VAE:
one DiT forward on the inputs the program's DiT took at one step, and the
sampler replayed over the velocities the program's DiT returned. The
weights are drawn again from the seed (`cofbench.families.wan_layouts`),
one model at a time, so that the 14B's fit with nothing else on the
card."""

from __future__ import annotations

import sys
import time

import torch

from cofbench.families import wan_layouts as layouts

from . import dit, rope, t5, tokenizer, unipc, vae

FP8_MAX = 448.0       # the largest finite float8_e4m3fn


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude to 448), back in float32: an operand as an fp8
    product would take it."""
    scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def to_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x * 127.5 + 127.5).clamp(0, 255).to(torch.uint8)


def _precise():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def encode_text(config, prompt, text_len, seed, device, served_dtype,
                quant=None):
    """umT5 embeddings [1, text_len, dim], zeroed past the instruction."""
    tcfg = config["text_encoder"]
    ids, mask = tokenizer.tokenize(prompt, text_len, tcfg["vocab"])
    ids, mask = (torch.as_tensor(a, device=device) for a in (ids, mask))
    sd = layouts.t5_weights(config, seed, device, served_dtype)
    return t5.encode(sd, tcfg, ids, mask, quant) * mask[..., None]


def vae_weights(config, seed, device, served_dtype, quant=None):
    return vae.Weights(layouts.vae_weights(config, seed, device, served_dtype),
                       device, quant)


def encode_clip(W, config, clip: torch.Tensor, streamed: bool = False
                ) -> torch.Tensor:
    """The normalised latent mean of a uint8 clip."""
    return vae.encode(W, config["vae"], clip.float() * (2.0 / 255.0) - 1.0,
                      streamed)


def denoise(config, mix, seed, starts, src, ground, device, served_dtype,
            quant=None):
    """The sampler's trajectory from each (latents, context) of ``starts``,
    latents [source mean | noise], with one draw of the weights: every step
    one DiT forward with the LoRA merged (``quant`` rounding the operands
    of its linears), then the source frozen. Returns the final latents of
    each."""
    dcfg = config["dit"]
    table = rope_table(config, mix, starts[0][0].shape, src, ground, device)
    D = dit_weights(config, seed, device, served_dtype, quant)
    out = []
    for latents, context in starts:
        sampler = unipc.UniPC(mix.steps, mix.shift)
        for i, t in enumerate(unipc.timesteps(mix.steps, mix.shift)):
            v = dit.forward(D, dcfg, latents, float(t), context, table)
            v[:, :, :src] = 0.0
            latents = sampler.step(v, i, latents)
        out.append(latents)
    return out


def rope_table(config, mix, shape, src, ground, device) -> torch.Tensor:
    """The chain-of-frames RoPE table (RIFLEx where the mix asks) of
    latents of ``shape``."""
    dcfg = config["dit"]
    patch = dcfg["patch_size"]
    grid = (shape[2] // patch[0], shape[3] // patch[1], shape[4] // patch[2])
    return rope.rope_table(grid, dcfg["dim"] // dcfg["num_heads"], src,
                           ground, mix.riflex_k, mix.riflex_frames or 66
                           ).to(device)


def dit_weights(config, seed, device, served_dtype, quant=None):
    """The DiT's weights drawn again, the LoRA files' deltas beside them."""
    sd = layouts.dit_weights(config, seed, device, served_dtype)
    loras = layouts.lora_files(config, seed, device, served_dtype)
    return dit.Weights(sd, dit.lora_deltas(loras, config["dit"]["num_layers"]),
                       device, quant)


def replay(mix, start, velocities, src, device, quant=None) -> torch.Tensor:
    """The sampler from ``start`` over the given velocities of each step
    (the source frames frozen), to the final latents; ``quant`` rounds the
    state after each step (the control)."""
    sampler, x = unipc.UniPC(mix.steps, mix.shift), start
    for i, v in enumerate(velocities):
        v = v.to(device, torch.float32).clone()
        v[:, :, :src] = 0.0
        x = sampler.step(v, i, x)
        if quant is not None:
            x = quant(x)
    return x


def step(config, mix, seed, taken, src, ground, device, served_dtype,
         quant=None) -> torch.Tensor:
    """One float32 DiT forward on the inputs the program's DiT took at a
    step (``x``, ``t``, ``context``), with the reference's RoPE and
    RIFLEx."""
    x = taken["x"].to(device, torch.float32)
    D = dit_weights(config, seed, device, served_dtype, quant)
    table = rope_table(config, mix, x.shape, src, ground, device)
    return dit.forward(D, config["dit"], x, float(taken["t"][0]),
                       taken["context"].to(device, torch.float32), table)


def decode(W, config, latents, src, ground, streamed: bool = False
           ) -> torch.Tensor:
    """The reasoning and the edit segments decoded apart, as uint8 frames."""
    parts = [latents[:, :, src:src + ground]] if ground else []
    parts.append(latents[:, :, src + ground:])
    return torch.cat([to_u8(vae.decode(W, config["vae"], p, streamed))
                      for p in parts], dim=2)


def _supported(mix):
    if mix.guidance_scale > 1.0 or mix.sampler != "unipc":
        raise NotImplementedError(
            f"the reference runs Flow-UniPC without guidance; mix {mix.name} "
            f"asks for {mix.sampler} at guidance {mix.guidance_scale}")


@torch.no_grad()
def run(config: dict, mix, seed: int, index: int, device,
        served_dtype=torch.bfloat16):
    """The whole edit ``index`` of a run with ``seed``: (frames
    [1, 3, T, H, W] uint8, final latents [1, z, F, h, w] float32), on the
    host."""
    _supported(mix)
    _precise()
    e = mix.edit(seed, index, config["vae"]["z_dim"], device)
    context = encode_text(config, e["prompt"], mix.text_len, seed, device,
                          served_dtype)
    W = vae_weights(config, seed, device, served_dtype)
    mu = encode_clip(W, config, e["clip"])
    src, ground = mu.shape[2], e["noise"].shape[2] - mu.shape[2]
    latents, = denoise(config, mix, seed,
                       [(torch.cat([mu, e["noise"]], dim=2), context)], src,
                       ground, device, served_dtype)
    return decode(W, config, latents, src, ground).cpu(), latents.cpu()


@torch.no_grad()
def check_products(config: dict, mix, seed: int, index: int, context,
                   latents, device, served_dtype=torch.bfloat16,
                   whole: bool = False) -> dict:
    """What edit ``index``'s stages should have produced, each from the
    inputs the benchmark drew and, past the stage it checks, from the
    program's own products (``context``, its prompt embeddings; ``latents``,
    its final latents, whose first frames are its source latents):
    ``context`` (umT5), ``source`` (the VAE's encode of the clip),
    ``latents`` (the trajectory from the program's source latents, the
    drawn noise and the program's embeddings) and ``frames`` (the decode of
    the program's final latents). With ``whole``, also ``whole``: the final
    latents of the reference's own edit, its trajectory from its own
    embeddings and source latents (`run`'s). All on the host."""
    _supported(mix)
    _precise()
    e = mix.edit(seed, index, config["vae"]["z_dim"], device)
    ref_ctx = encode_text(config, e["prompt"], mix.text_len, seed, device,
                          served_dtype)
    out = {"context": ref_ctx.cpu()}
    W = vae_weights(config, seed, device, served_dtype)
    mu = encode_clip(W, config, e["clip"])
    out["source"] = mu.cpu()
    src, ground = mu.shape[2], e["noise"].shape[2] - mu.shape[2]
    lat = torch.as_tensor(latents, device=device, dtype=torch.float32)
    ctx = torch.as_tensor(context, device=device, dtype=torch.float32)
    starts = [(torch.cat([lat[:, :, :src], e["noise"]], dim=2), ctx)]
    if whole:
        starts.append((torch.cat([mu, e["noise"]], dim=2), ref_ctx))
    ends = denoise(config, mix, seed, starts, src, ground, device,
                   served_dtype)
    out["latents"] = ends[0].cpu()
    if whole:
        out["whole"] = ends[1].cpu()
    out["frames"] = decode(W, config, lat, src, ground).cpu()
    return out


@torch.no_grad()
def step_products(config: dict, mix, seed: int, index: int, context,
                  latents, calls: dict, device,
                  served_dtype=torch.bfloat16) -> dict:
    """What edit ``index``'s stages should have produced, as
    `check_products` has it, with the streamed VAE, and two stages in place
    of the trajectory: ``step``, the DiT's velocity at the step the program
    kept the inputs of (``calls``: the program's `DiTCalls`), and
    ``replay``, the final latents of the sampler from the program's source
    latents and the drawn noise over the velocities the program's DiT
    returned. Prints each stage's seconds to standard error. All on the
    host."""
    _supported(mix)
    _precise()
    t0 = time.perf_counter()
    stages = []

    def tick(name):
        nonlocal t0
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        stages.append(f"{name} {now - t0:.3f} s")
        t0 = now

    e = mix.edit(seed, index, config["vae"]["z_dim"], device)
    out = {"context": encode_text(config, e["prompt"], mix.text_len, seed,
                                  device, served_dtype).cpu()}
    tick("umT5")
    W = vae_weights(config, seed, device, served_dtype)
    out["source"] = encode_clip(W, config, e["clip"], streamed=True).cpu()
    tick("VAE encode")
    src = out["source"].shape[2]
    ground = e["noise"].shape[2] - src
    lat = torch.as_tensor(latents, device=device, dtype=torch.float32)
    start = torch.cat([lat[:, :, :src], e["noise"]], dim=2)
    out["replay"] = replay(mix, start, calls["velocity"], src, device).cpu()
    tick("sampler")
    if calls["inputs"] is not None:
        out["step"] = step(config, mix, seed, calls["inputs"], src, ground,
                           device, served_dtype).cpu()
    tick(f"DiT step {calls['keep']}")
    out["frames"] = decode(W, config, lat, src, ground, streamed=True).cpu()
    tick("VAE decode")
    print("cofbench: reference stages: " + ", ".join(stages),
          file=sys.stderr, flush=True)
    return out
