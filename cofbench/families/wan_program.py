"""The system under test of the Wan family, `videocof_torch`'s
`WanPipeline`, as the benchmark drives it: the pipeline built from the
benchmark's published-layout weights through the port's own checkpoint
converters (what `factory.load_pipeline` does with a checkpoint directory,
without writing 28.6 GB to disk first), the LoRA files merged in order by
`models.lora.merge_lora`, and one edit as a user calls
`WanPipeline.__call__`. This module is the only one of the family
that imports the program."""

from __future__ import annotations

from typing import Optional

import torch


def dit_config(config: dict):
    from videocof_torch.configs import WanDiTConfig
    c = config["dit"]
    return WanDiTConfig(
        model_type=c["model_type"], patch_size=tuple(c["patch_size"]),
        text_len=c["text_len"], in_dim=c["in_dim"], dim=c["dim"],
        ffn_dim=c["ffn_dim"], freq_dim=c["freq_dim"], text_dim=c["text_dim"],
        out_dim=c["out_dim"], num_heads=c["num_heads"],
        num_layers=c["num_layers"], cross_attn_norm=c["cross_attn_norm"],
        eps=c["eps"])


def vae_config(config: dict):
    from videocof_torch.configs import WanVAEConfig
    c = config["vae"]
    return WanVAEConfig(
        dim=c["dim"], z_dim=c["z_dim"], dim_mult=tuple(c["dim_mult"]),
        num_res_blocks=c["num_res_blocks"],
        temporal_downsample=tuple(c["temporal_downsample"]),
        latent_mean=tuple(c["latent_mean"]),
        latent_std=tuple(c["latent_std"]))


def t5_config(config: dict):
    from videocof_torch.configs import T5Config
    c = config["text_encoder"]
    return T5Config(vocab=c["vocab"], dim=c["dim"], dim_attn=c["dim_attn"],
                    dim_ffn=c["dim_ffn"], num_heads=c["num_heads"],
                    num_layers=c["num_layers"], num_buckets=c["num_buckets"],
                    rel_max_dist=c["rel_max_dist"])


def build(config: dict, raw_dit, raw_vae, raw_t5, loras, device,
          dtype=torch.bfloat16):
    """A `WanPipeline` holding the given published-layout weights (the
    tensors themselves where the dtype matches), the LoRA state dicts
    merged in order."""
    from videocof_torch.models import weights
    from videocof_torch.models.lora import merge_lora
    from videocof_torch.models.t5_encoder import T5Encoder
    from videocof_torch.models.wan_dit import WanDiT
    from videocof_torch.models.wan_vae import WanVAE
    from videocof_torch.pipeline import WanPipeline
    dcfg, vcfg, tcfg = dit_config(config), vae_config(config), t5_config(
        config)
    dit = weights.module_from_state_dict(
        WanDiT, dcfg, weights.convert_dit_state_dict(raw_dit, dcfg, dtype),
        dtype, device)
    for sd, mult in loras:
        merge_lora(dit, sd, multiplier=mult)
    vae = weights.module_from_state_dict(
        WanVAE, vcfg, weights.convert_vae_state_dict(raw_vae, vcfg, dtype),
        dtype, device)
    t5 = weights.module_from_state_dict(
        T5Encoder, tcfg, weights.convert_t5_state_dict(raw_t5, tcfg, dtype),
        dtype, device)
    return WanPipeline(dit, vae, t5, dtype=dtype, device=device)


def quantize_fp8(pipe) -> None:
    """Store the pipeline's DiT weights in fp8 in place (the control)."""
    from videocof_torch.utils.fp8 import quantize_dit_fp8
    quantize_dit_fp8(pipe.dit)


def edit(pipe, mix, e: dict, timings=None, steps=None):
    """One edit as a user calls it: (the frames, float32 in [0, 1],
    [1, 3, T, H, W], and the final latents), on the host."""
    out = pipe(e["clip"], e["prompt"], source_frames=mix.source_frames,
               reasoning_frames=mix.reasoning_frames,
               num_inference_steps=steps or mix.steps,
               guidance_scale=mix.guidance_scale, shift=mix.shift,
               sampler=mix.sampler, repeat_rope=True, cot=True,
               max_sequence_length=mix.text_len, riflex_k=mix.riflex_k,
               riflex_L_test=mix.riflex_frames, noise=e["noise"],
               output_latents=True, timings=timings)
    return out.videos, out.latents


def keep_text(pipe) -> list:
    """Keep the prompt embedding of the pipeline's latest text stage (the
    comparison reads the timed call's own) in a list of one slot, which
    the caller empties; returns the list."""
    kept = []
    real = pipe.encode_prompt

    def encode(*args, **kw):
        out = real(*args, **kw)
        kept[:] = [out]
        return out
    pipe.encode_prompt = encode
    return kept


def trace_spans(pipe):
    """Wrap the calls into the text encoder, the VAE and the DiT with
    `torch.profiler.record_function` spans named after the layer (traced
    runs only)."""
    from torch.profiler import record_function

    def spanned(name, fn):
        def call(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return call

    pipe.encode_prompt = spanned("cof.text", pipe.encode_prompt)
    pipe.vae_encode = spanned("cof.vae_encode", pipe.vae_encode)
    pipe.decode_to_u8 = spanned("cof.vae_decode", pipe.decode_to_u8)
    pipe.dit.forward_with_residual = spanned(
        "cof.dit", pipe.dit.forward_with_residual)


class DiTCalls:
    """Host copies of what the DiT computed in one edit: each call's
    velocity, and the inputs of call ``keep`` (the latents, timestep and
    prompt embeddings as the DiT took them). Nothing stays on the card."""

    def __init__(self):
        self.keep: Optional[int] = None
        self.velocity: list = []
        self.inputs: Optional[dict] = None

    def start(self, keep: int) -> None:
        self.keep, self.velocity, self.inputs = keep, [], None

    def take(self) -> dict:
        out = {"velocity": self.velocity, "inputs": self.inputs,
               "keep": self.keep}
        self.velocity, self.inputs = [], None
        return out


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy (a CPU tensor too is copied: the pipeline writes into
    the velocity after the call)."""
    return t.to("cpu", copy=True)


def capture_dit(pipe) -> DiTCalls:
    """Wrap the pipeline's DiT forward so that each call leaves its host
    copies in the returned `DiTCalls` (the velocity before the pipeline
    freezes the source frames in place)."""
    calls = DiTCalls()
    real = pipe.dit.forward_with_residual

    def forward(x, t, context, *args, **kw):
        out = real(x, t, context, *args, **kw)
        if len(calls.velocity) == calls.keep:
            calls.inputs = {"x": _host(x), "t": _host(t),
                            "context": _host(context)}
        calls.velocity.append(_host(out[0]))
        return out
    pipe.dit.forward_with_residual = forward
    return calls
