"""The Wan family's weights: the published checkpoint layouts the benchmark
draws them in, and their draws from the seed (one stream a model). Every
key of a Wan2.1 DiT (``diffusion_pytorch_model*.safetensors``), of the
Wan2.1 VAE (``Wan2.1_VAE.pth``), of the umT5-XXL encoder
(``models_t5_umt5-xxl-enc-bf16.pth``) and of a LoRA file (kohya or PEFT),
each with its shape and the mean and standard deviation it is drawn with.

The draws keep a forward pass of random weights in a working range: linear
and convolution weights N(0, 1/fan_in) (the variance of the input is
kept), biases N(0, 0.05^2), gains 1 + N(0, 0.1^2); the q and k RMS-norm
gains 1.5 + N(0, 0.25^2), so that attention logits spread by about 2.3 and
each query attends to a few hundred keys rather than to all of them alike;
AdaLN modulations N(0, 1/dim); umT5 with its published initialiser's
scales; LoRA down N(0, 1/d_in), up N(0, 0.02^2)."""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from cofbench.inputs import draw, sub_seed

Entry = Tuple[str, Tuple[int, ...], float, float]    # key, shape, mean, std

BIAS_STD = 0.05
GAIN_STD = 0.1
QK_GAIN = (1.5, 0.25)


def _linear(name, dout, din, bias=True) -> List[Entry]:
    out = [(name + ".weight", (dout, din), 0.0, din ** -0.5)]
    if bias:
        out.append((name + ".bias", (dout,), 0.0, BIAS_STD))
    return out


def dit(cfg: dict) -> List[Entry]:
    d, f, td, fd = cfg["dim"], cfg["ffn_dim"], cfg["text_dim"], cfg["freq_dim"]
    pt, ph, pw = cfg["patch_size"]
    fan = cfg["in_dim"] * pt * ph * pw
    out: List[Entry] = [
        ("patch_embedding.weight", (d, cfg["in_dim"], pt, ph, pw), 0.0,
         fan ** -0.5),
        ("patch_embedding.bias", (d,), 0.0, BIAS_STD)]
    out += _linear("text_embedding.0", d, td) + _linear("text_embedding.2",
                                                        d, d)
    out += _linear("time_embedding.0", d, fd) + _linear("time_embedding.2",
                                                        d, d)
    out += _linear("time_projection.1", 6 * d, d)
    for i in range(cfg["num_layers"]):
        p = f"blocks.{i}."
        for a in ("self_attn", "cross_attn"):
            for n in "qkvo":
                out += _linear(f"{p}{a}.{n}", d, d)
            out += [(f"{p}{a}.norm_q.weight", (d,), *QK_GAIN),
                    (f"{p}{a}.norm_k.weight", (d,), *QK_GAIN)]
        out += [(p + "norm3.weight", (d,), 1.0, GAIN_STD),
                (p + "norm3.bias", (d,), 0.0, BIAS_STD)]
        out += _linear(p + "ffn.0", f, d) + _linear(p + "ffn.2", d, f)
        out.append((p + "modulation", (1, 6, d), 0.0, d ** -0.5))
    out += _linear("head.head", cfg["out_dim"] * pt * ph * pw, d)
    out.append(("head.modulation", (1, 2, d), 0.0, d ** -0.5))
    return out


def lora_modules(cfg: dict) -> List[Tuple[str, int, int]]:
    """(published module name, d_in, d_out) of every linear a Wan LoRA file
    adapts: the ten of each block."""
    d, f = cfg["dim"], cfg["ffn_dim"]
    out = []
    for i in range(cfg["num_layers"]):
        for a in ("self_attn", "cross_attn"):
            out += [(f"blocks.{i}.{a}.{n}", d, d) for n in "qkvo"]
        out += [(f"blocks.{i}.ffn.0", d, f), (f"blocks.{i}.ffn.2", f, d)]
    return out


def lora(cfg: dict, fmt: str, rank: int) -> List[Entry]:
    """A LoRA file's factors: kohya (``lora_unet_<name, dots as
    underscores>.lora_down/.lora_up``; its ``.alpha`` scalars are not drawn)
    or PEFT (``<name>.lora_A/.lora_B``)."""
    out: List[Entry] = []
    for name, din, dout in lora_modules(cfg):
        if fmt == "kohya":
            base = "lora_unet_" + name.replace(".", "_")
            down, up = base + ".lora_down.weight", base + ".lora_up.weight"
        else:
            down, up = name + ".lora_A.weight", name + ".lora_B.weight"
        out += [(down, (rank, din), 0.0, din ** -0.5),
                (up, (dout, rank), 0.0, 0.02)]
    return out


def _conv(name, cout, cin, kernel) -> List[Entry]:
    fan = cin * math.prod(kernel)
    return [(name + ".weight", (cout, cin, *kernel), 0.0, fan ** -0.5),
            (name + ".bias", (cout,), 0.0, BIAS_STD)]


def _residual(p, cin, cout) -> List[Entry]:
    out = [(p + ".residual.0.gamma", (cin, 1, 1, 1), 1.0, GAIN_STD)]
    out += _conv(p + ".residual.2", cout, cin, (3, 3, 3))
    out.append((p + ".residual.3.gamma", (cout, 1, 1, 1), 1.0, GAIN_STD))
    out += _conv(p + ".residual.6", cout, cout, (3, 3, 3))
    if cin != cout:
        out += _conv(p + ".shortcut", cout, cin, (1, 1, 1))
    return out


def _middle(p, c) -> List[Entry]:
    out = _residual(p + ".middle.0", c, c)
    out.append((p + ".middle.1.norm.gamma", (c, 1, 1), 1.0, GAIN_STD))
    out += _conv(p + ".middle.1.to_qkv", 3 * c, c, (1, 1))
    out += _conv(p + ".middle.1.proj", c, c, (1, 1))
    return out + _residual(p + ".middle.2", c, c)


def vae(cfg: dict) -> List[Entry]:
    dim, mult, nres = cfg["dim"], cfg["dim_mult"], cfg["num_res_blocks"]
    z = cfg["z_dim"]
    dims = [dim * u for u in [1] + list(mult)]
    out = _conv("encoder.conv1", dims[0], 3, (3, 3, 3))
    n = 0
    for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
        for _ in range(nres):
            out += _residual(f"encoder.downsamples.{n}", cin, cout)
            cin, n = cout, n + 1
        if i != len(mult) - 1:
            p = f"encoder.downsamples.{n}"
            out += _conv(p + ".resample.1", cout, cout, (3, 3))
            if cfg["temporal_downsample"][i]:
                out += _conv(p + ".time_conv", cout, cout, (3, 1, 1))
            n += 1
    out += _middle("encoder", dims[-1])
    out.append(("encoder.head.0.gamma", (dims[-1], 1, 1, 1), 1.0, GAIN_STD))
    out += _conv("encoder.head.2", 2 * z, dims[-1], (3, 3, 3))
    out += _conv("conv1", 2 * z, 2 * z, (1, 1, 1))
    out += _conv("conv2", z, z, (1, 1, 1))
    ddims = [dim * u for u in [mult[-1]] + list(reversed(mult))]
    upsample = list(reversed(cfg["temporal_downsample"]))
    out += _conv("decoder.conv1", ddims[0], z, (3, 3, 3))
    out += _middle("decoder", ddims[0])
    n = 0
    for i, (cin, cout) in enumerate(zip(ddims[:-1], ddims[1:])):
        if i > 0:
            cin //= 2
        for _ in range(nres + 1):
            out += _residual(f"decoder.upsamples.{n}", cin, cout)
            cin, n = cout, n + 1
        if i != len(mult) - 1:
            p = f"decoder.upsamples.{n}"
            out += _conv(p + ".resample.1", cout // 2, cout, (3, 3))
            if upsample[i]:
                out += _conv(p + ".time_conv", 2 * cout, cout, (3, 1, 1))
            n += 1
    out.append(("decoder.head.0.gamma", (ddims[-1], 1, 1, 1), 1.0, GAIN_STD))
    out += _conv("decoder.head.2", 3, ddims[-1], (3, 3, 3))
    return out


def t5(cfg: dict) -> List[Entry]:
    d, da, df = cfg["dim"], cfg["dim_attn"], cfg["dim_ffn"]
    h = cfg["num_heads"]
    out: List[Entry] = [("token_embedding.weight", (cfg["vocab"], d), 0.0,
                         1.0)]
    for i in range(cfg["num_layers"]):
        p = f"blocks.{i}."
        out += [(p + "norm1.weight", (d,), 1.0, GAIN_STD),
                (p + "attn.q.weight", (da, d), 0.0, (d * da) ** -0.5),
                (p + "attn.k.weight", (da, d), 0.0, d ** -0.5),
                (p + "attn.v.weight", (da, d), 0.0, d ** -0.5),
                (p + "attn.o.weight", (d, da), 0.0, (h * da) ** -0.5),
                (p + "norm2.weight", (d,), 1.0, GAIN_STD),
                (p + "ffn.gate.0.weight", (df, d), 0.0, d ** -0.5),
                (p + "ffn.fc1.weight", (df, d), 0.0, d ** -0.5),
                (p + "ffn.fc2.weight", (d, df), 0.0, df ** -0.5),
                (p + "pos_embedding.embedding.weight",
                 (cfg["num_buckets"], h), 0.0,
                 (2 * cfg["num_buckets"] * h) ** -0.5)]
    out.append(("norm.weight", (d,), 1.0, GAIN_STD))
    return out


def dit_weights(config: dict, seed: int, device, dtype):
    return draw(dit(config["dit"]), sub_seed(seed, "dit"), device, dtype)


def vae_weights(config: dict, seed: int, device, dtype):
    return draw(vae(config["vae"]), sub_seed(seed, "vae"), device, dtype)


def t5_weights(config: dict, seed: int, device, dtype):
    return draw(t5(config["text_encoder"]), sub_seed(seed, "t5"), device,
                dtype)


def lora_files(config: dict, seed: int, device, dtype):
    """[(LoRA state dict, multiplier)] of the configuration's ``lora`` list,
    in order; a kohya file carries its ``alpha`` per module."""
    files = []
    for spec in config.get("lora", ()):
        sd = draw(lora(config["dit"], spec["format"], spec["rank"]),
                  sub_seed(seed, "lora", spec["name"]), device, dtype)
        if spec["format"] == "kohya":
            for key in [k for k in sd if k.endswith(".lora_down.weight")]:
                sd[key[:-len(".lora_down.weight")] + ".alpha"] = torch.tensor(
                    float(spec["alpha"]))
        files.append((sd, float(spec["multiplier"])))
    return files
