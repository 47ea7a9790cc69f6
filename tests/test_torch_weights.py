"""The port's checkpoint files against the JAX package's: its safetensors
reader and writer against the ``safetensors`` package, its converters of the
published DiT, VAE and umT5 layouts against JAX's converters followed by
`videocof_torch.convert` (bitwise), and its export of the DiT against JAX's.
The published state dicts are filled from a numpy seed at the tiny
configs."""

import json
import os

import jax
import numpy as np
import pytest
import safetensors.torch
import torch

from videocof_tpu.configs import T5_TINY as J_T5, VAE_TINY as J_VAE
from videocof_tpu.configs import WAN_TINY as J_WAN
from videocof_tpu.models import wan_dit as jdit
from videocof_tpu.models import weights as jweights
from videocof_tpu.utils import checkpoint as jckpt
from videocof_torch import convert
from videocof_torch.configs import (T5Config, WAN21_T2V_1_3B, WanDiTConfig,
                                    WanVAEConfig)
from videocof_torch.models import weights
from videocof_torch.models.t5_encoder import T5Encoder
from videocof_torch.models.wan_dit import WanDiT
from videocof_torch.models.wan_vae import WanVAE
from videocof_torch.utils import checkpoint

from _published_layouts import t5_published_name, vae_published_name

torch.set_num_threads(1)

CFG = convert.config_from(WanDiTConfig, J_WAN)
VCFG = convert.config_from(WanVAEConfig, J_VAE)
TCFG = convert.config_from(T5Config, J_T5)
STORED = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _fill(shapes, seed):
    """{name: shape} -> {name: fp32 tensor} from a numpy seed."""
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for k, s in shapes.items()}


def _jax_dit_params(seed=0):
    """JAX DiT params of WAN_TINY's tree, every leaf drawn from a numpy
    seed as fp32."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jdit.init_wan_dit(jax.random.PRNGKey(0),
                                                      J_WAN))
    return jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), shapes)


def _published_dit(seed=0):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in jckpt.export_dit_state_dict(_jax_dit_params(seed),
                                                    J_WAN).items()}


class _Recording(dict):
    """A state dict that records which keys a converter read."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def _published(kind, seed=0):
    if kind == "dit":
        return _published_dit(seed)
    module, rename = {"vae": (WanVAE(VCFG),
                              lambda k: vae_published_name(k, VCFG)),
                      "t5": (T5Encoder(TCFG), t5_published_name)}[kind]
    return _fill({rename(k): tuple(v.shape)
                  for k, v in module.state_dict().items()}, seed)


def _write(sd, tmp_path, layout):
    """Write ``sd`` in ``layout``; returns the path a loader takes."""
    if layout == "safetensors":
        path = str(tmp_path / "model.safetensors")
        safetensors.torch.save_file(sd, path)
    elif layout in ("sharded", "sharded_no_index"):
        path = str(tmp_path / "shards")
        os.makedirs(path)
        names = sorted(sd)
        halves = {f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors":
                  names[i::2] for i in range(2)}
        for fname, keys in halves.items():
            safetensors.torch.save_file({k: sd[k] for k in keys},
                                        os.path.join(path, fname))
        if layout == "sharded":
            with open(os.path.join(path, weights.DIT_INDEX), "w") as f:
                json.dump({"weight_map": {k: fname for fname, keys in
                                          halves.items() for k in keys}}, f)
    else:
        path = str(tmp_path / "model.pth")
        torch.save({"state_dict": sd} if layout == "pth_nested" else sd, path)
    return path


def _jax_convert(kind, sd_np):
    if kind == "dit":
        return convert.dit_from_jax(jax.tree.map(
            np.asarray, jweights.convert_dit_state_dict(sd_np, J_WAN)))
    if kind == "vae":
        return convert.vae_from_jax(jax.tree.map(
            np.asarray, jweights.convert_vae_state_dict(sd_np, J_VAE)))
    return convert.t5_from_jax(jax.tree.map(
        np.asarray, jweights.convert_t5_state_dict(sd_np, J_T5)))


def _port_convert(kind, sd, dtype=torch.float32):
    fn, cfg = {"dit": (weights.convert_dit_state_dict, CFG),
               "vae": (weights.convert_vae_state_dict, VCFG),
               "t5": (weights.convert_t5_state_dict, TCFG)}[kind]
    return fn(sd, cfg, dtype)


def _assert_bitwise(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


# --------------------------------------------------------------- safetensors

def _tensors(dtype):
    rng = np.random.default_rng(0)

    def make(*shape):
        if dtype.is_floating_point:
            return torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(dtype)
        return torch.from_numpy(rng.integers(0, 100, shape)).to(dtype)

    return {"a.weight": make(5, 7), "b": make(3), "scalar": make(),
            "c.bias": make(2, 3, 4), "empty": make(0, 4)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16, torch.int64, torch.int32,
                                   torch.uint8],
                         ids=lambda d: str(d)[6:])
def test_reader_matches_safetensors_package(tmp_path, dtype):
    want = _tensors(dtype)
    mixed = {**want, "mixed_f32": torch.ones(3, 2), "mixed_u8": torch.arange(
        5, dtype=torch.uint8)}
    path = str(tmp_path / "t.safetensors")
    safetensors.torch.save_file(mixed, path, metadata={"format": "pt"})
    _assert_bitwise(weights.read_safetensors(path), mixed)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16, torch.int64, torch.int32,
                                   torch.uint8],
                         ids=lambda d: str(d)[6:])
def test_writer_read_by_safetensors_package(tmp_path, dtype):
    want = {**_tensors(dtype), "mixed_f32": torch.ones(3, 2)}
    path = str(tmp_path / "t.safetensors")
    n = checkpoint.write_safetensors(path, want)
    assert n == os.path.getsize(path)
    _assert_bitwise(safetensors.torch.load_file(path), want)
    _assert_bitwise(weights.read_safetensors(path), want)


def test_reader_tensors_are_writable_and_leave_the_file(tmp_path):
    path = str(tmp_path / "t.safetensors")
    safetensors.torch.save_file({"w": torch.zeros(4)}, path)
    t = weights.read_safetensors(path)["w"]
    t.add_(1.0)
    assert torch.equal(weights.read_safetensors(path)["w"], torch.zeros(4))


def test_reader_rejects_broken_files(tmp_path):
    path = str(tmp_path / "t.safetensors")
    safetensors.torch.save_file({"w": torch.zeros(4)}, path)
    with open(path, "rb") as f:
        raw = f.read()
    with open(path, "wb") as f:
        f.write(raw[:-4])                     # truncated data
    with pytest.raises(ValueError):
        weights.read_safetensors(path)
    with open(path, "wb") as f:
        f.write(raw[:4])                      # truncated header length
    with pytest.raises(ValueError):
        weights.read_safetensors(path)


# ---------------------------------------------------------------- converters

@pytest.mark.parametrize("stored", ["fp32", "bf16"])
@pytest.mark.parametrize("layout", ["safetensors", "sharded",
                                    "sharded_no_index", "pth", "pth_nested"])
@pytest.mark.parametrize("kind", ["dit", "vae", "t5"])
def test_converter_matches_jax(tmp_path, kind, layout, stored):
    sd = {k: v.to(STORED[stored]) for k, v in _published(kind).items()}
    path = _write(sd, tmp_path, layout)
    want = _jax_convert(kind, jweights.load_state_dict(path))
    loaded = weights.load_state_dict(path)
    assert all(v.dtype == STORED[stored] for v in loaded.values())
    _assert_bitwise(_port_convert(kind, loaded), want)
    # in bf16: the fp32 conversion rounded, but the fp32 islands
    got16 = _port_convert(kind, loaded, torch.bfloat16)
    module = {"dit": WanDiT(CFG), "vae": WanVAE(VCFG),
              "t5": T5Encoder(TCFG)}[kind].to(torch.bfloat16)
    for k, p in module.state_dict().items():
        assert got16[k].dtype == (torch.float32 if k.endswith(
            ("modulation", "pos_emb")) or k.startswith(("time_mlp.",
                                                        "time_proj."))
            else torch.bfloat16), k
        assert torch.equal(got16[k], want[k].to(got16[k].dtype)), k


@pytest.mark.parametrize("kind", ["dit", "vae", "t5"])
def test_jax_converter_reads_every_published_key(kind):
    """The published dicts of these tests hold exactly the keys that JAX's
    converter reads, and the port's module takes what the port's makes."""
    sd = _Recording({k: v.numpy() for k, v in _published(kind).items()})
    _jax_convert(kind, sd)
    assert sd.read == set(sd)
    module = {"dit": WanDiT(CFG), "vae": WanVAE(VCFG),
              "t5": T5Encoder(TCFG)}[kind]
    module.load_state_dict(_port_convert(kind, _published(kind)))


def test_vae_takes_the_model_prefix():
    sd = _published("vae")
    _assert_bitwise(_port_convert("vae", {"model." + k: v
                                          for k, v in sd.items()}),
                    _port_convert("vae", sd))


# ------------------------------------------------------------------- export

def test_export_matches_jax():
    params = _jax_dit_params(3)
    want = jckpt.export_dit_state_dict(params, J_WAN)
    got = checkpoint.export_dit_state_dict(convert.dit_from_jax(params), CFG)
    _assert_bitwise(got, {k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in want.items()})


def test_export_inverts_convert():
    sd = _published_dit(4)
    _assert_bitwise(checkpoint.export_dit_state_dict(
        weights.convert_dit_state_dict(sd, CFG), CFG), sd)


@pytest.mark.parametrize("num_shards", [1, 2, 3])
def test_checkpoint_dir_round_trip(tmp_path, num_shards):
    dit = WanDiT(CFG, dtype=torch.bfloat16)
    dit.load_state_dict(convert.dit_from_jax(_jax_dit_params(5)))
    checkpoint.save_dit_checkpoint_dir(str(tmp_path), dit, CFG, num_shards)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".safetensors")]
    assert len(files) == num_shards
    assert weights.dit_config_from_checkpoint(str(tmp_path)) == CFG
    assert convert.config_from(
        WanDiTConfig, jweights.dit_config_from_checkpoint(str(tmp_path))) == CFG
    got = weights.convert_dit_state_dict(
        weights.load_state_dict(str(tmp_path)), CFG, torch.bfloat16)
    _assert_bitwise(got, dit.state_dict())
    # JAX reads the same directory to the same values
    want = _jax_convert("dit", jweights.load_state_dict(str(tmp_path)))
    _assert_bitwise(weights.convert_dit_state_dict(
        weights.load_state_dict(str(tmp_path)), CFG), want)


def test_save_dit_safetensors_loads_in_jax(tmp_path):
    dit = WanDiT(CFG)
    dit.load_state_dict(convert.dit_from_jax(_jax_dit_params(6)))
    path = str(tmp_path / "dit.safetensors")
    checkpoint.save_dit_safetensors(path, dit, CFG)
    _assert_bitwise(_jax_convert("dit", jweights.load_state_dict(path)),
                    dit.state_dict())


def test_config_of_the_published_1_3b(tmp_path):
    with open(tmp_path / "config.json", "w") as f:
        json.dump(checkpoint.dit_checkpoint_config(WAN21_T2V_1_3B), f)
    assert weights.dit_config_from_checkpoint(str(tmp_path)) == WAN21_T2V_1_3B
    # the reference's own config.json of Wan2.1-T2V-1.3B names fewer keys
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"_class_name": "WanModel", "dim": 1536, "eps": 1e-06,
                   "ffn_dim": 8960, "freq_dim": 256, "in_dim": 16,
                   "model_type": "t2v", "num_heads": 12, "num_layers": 30,
                   "out_dim": 16, "text_len": 512}, f)
    assert weights.dit_config_from_checkpoint(str(tmp_path)) == WAN21_T2V_1_3B


@pytest.mark.parametrize("extra", ["img_emb.proj.0.weight",
                                   "blocks.0.cross_attn.k_img.weight",
                                   "vace_patch_embedding.weight",
                                   "control_adapter.conv.weight"])
def test_unported_branches_raise(extra):
    sd = _published_dit()
    sd[extra] = torch.zeros(1)
    with pytest.raises(NotImplementedError, match="A.10"):
        weights.convert_dit_state_dict(sd, CFG)


@pytest.mark.parametrize("raw", [{"model_type": "i2v"}, {"qk_norm": False}])
def test_unported_configs_raise(tmp_path, raw):
    with open(tmp_path / "config.json", "w") as f:
        json.dump({**checkpoint.dit_checkpoint_config(CFG), **raw}, f)
    with pytest.raises(NotImplementedError, match="A.10"):
        weights.dit_config_from_checkpoint(str(tmp_path))
