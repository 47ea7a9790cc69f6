"""The port's entries on Wan2.2 and fp8 against the JAX package's: the
factory on tiny published-layout checkpoint directories (the A14B MoE
layout written by `utils.checkpoint.save_wan_checkpoint_dir`, and the
TI2V-5B layout with ``Wan2.2_VAE.pth``) held against JAX's converters,
LoRA merge and numpy fp8 quantization on the same files; the random-init
path with fp8; ``--quantize fp8`` through both CLIs to the factory; and
``--t2v`` through both CLIs against JAX's CLIs with the same tiny weights
and noise (outputs captured before encoding)."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videocof_tpu.cli._common as jcommon
import videocof_tpu.cli.fast_infer as jcli
import videocof_tpu.cli.infer as jinfer
from videocof_tpu.configs import T5_TINY as J_T5, VAE_TINY as J_VAE
from videocof_tpu.configs import WAN_TINY as J_WAN
from videocof_tpu.models import lora as jlora, t5_encoder as jt5
from videocof_tpu.models import wan_dit as jdit, wan_vae as jvae
from videocof_tpu.models import wan_vae22 as jv22, weights as jweights
from videocof_tpu.pipeline import Wan22Pipeline as JaxWan22
from videocof_tpu.utils.fp8 import quantize_params_fp8
from videocof_torch import convert, factory
from videocof_torch.cli import _common as common
from videocof_torch.cli import fast_infer, infer
from videocof_torch.configs import (T5Config, WAN22_VAE_TINY, WanDiTConfig,
                                    Wan22VAEConfig, WanVAEConfig)
from videocof_torch.models.t5_encoder import T5Encoder
from videocof_torch.models.wan_dit import WanDiT, init_wan_dit
from videocof_torch.models.wan_vae import WanVAE
from videocof_torch.models.wan_vae22 import Wan22VAE
from videocof_torch.pipeline import Wan22Pipeline, WanPipeline
from videocof_torch.utils import checkpoint
from videocof_torch.utils.fp8 import is_fp8, quantize_dit_fp8

torch.set_num_threads(1)

DCFG = J_WAN.replace(in_dim=J_VAE.z_dim, out_dim=J_VAE.z_dim,
                     text_dim=J_T5.dim)
TDCFG = convert.config_from(WanDiTConfig, DCFG)
TVCFG = convert.config_from(WanVAEConfig, J_VAE)
TT5CFG = convert.config_from(T5Config, J_T5)
PROMPT = "a red kite over a quiet lake"


@pytest.fixture(autouse=True)
def _offline(monkeypatch):
    """The tiny directories have no tokenizer files: look nowhere else."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")


def _filled(module, seed):
    """``module`` with every tensor drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    module.load_state_dict({k: torch.from_numpy(
        0.2 * rng.standard_normal(tuple(v.shape)).astype(np.float32))
        for k, v in module.state_dict().items()})
    return module


def _lora_file(path, seed):
    """A rank-2 kohya LoRA over every block linear of the tiny DiT."""
    rng = np.random.default_rng(seed)
    d, f = TDCFG.dim, TDCFG.ffn_dim
    sd = {}
    for i in range(TDCFG.num_layers):
        for name, (din, dout) in [(f"{a}.{n}", (d, d)) for a in
                                  ("self_attn", "cross_attn") for n in "qkvo"
                                  ] + [("ffn.0", (d, f)), ("ffn.2", (f, d))]:
            base = "lora_unet_" + f"blocks.{i}.{name}".replace(".", "_")
            sd[base + ".lora_down.weight"] = 0.1 * rng.standard_normal(
                (2, din))
            sd[base + ".lora_up.weight"] = 0.1 * rng.standard_normal((dout, 2))
            sd[base + ".alpha"] = np.array(1.0)
    checkpoint.write_safetensors(path, {
        k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()})
    return path


def _moe_dir(root):
    """A tiny Wan2.2 A14B checkpoint directory in the published layout;
    returns the two experts, the VAE and umT5 written."""
    dit, dit2 = _filled(WanDiT(TDCFG), 1), _filled(WanDiT(TDCFG), 2)
    vae, t5 = _filled(WanVAE(TVCFG), 3), _filled(T5Encoder(TT5CFG), 4)
    checkpoint.save_wan_checkpoint_dir(root, dit, vae, t5, dit_2=dit2)
    return dit, dit2, vae, t5


def _jax_expert(expert_dir, loras):
    """JAX's factory path for one expert: its converter, the LoRA merges in
    order, the numpy fp8 quantization -> the port's state dict names."""
    params = jweights.convert_dit_state_dict(
        jweights.load_state_dict(expert_dir), DCFG)
    for path, mult in loras:
        params = jlora.merge_lora(params, DCFG, path, multiplier=mult)
    return quantize_params_fp8(jax.tree.map(np.asarray, params))


def _assert_fp8_equal(dit, qtree):
    """Every quantized linear of ``dit`` equal bit for bit, in fp8 bits and
    scale, to JAX's numpy quantization; the other weights unquantized."""
    seen = 0
    for name, mod in dit.named_modules():
        if not isinstance(mod, torch.nn.Linear):
            continue
        path = convert.jax_param_path(name + ".weight").split("/")
        node = qtree
        for p in path:
            node = node[p]
        assert is_fp8(mod) == isinstance(node, dict), name
        if not is_fp8(mod):
            continue
        q, s = node["fp8"], np.asarray(node["scale"], np.float32)
        if path[0] == "blocks":
            i = int(name.split(".")[1])
            q, s = q[i], s[i]
        np.testing.assert_array_equal(mod.weight.view(torch.uint8).numpy(),
                                      np.swapaxes(q, -1, -2).view(np.uint8))
        assert mod.weight_scale.numpy().tobytes() == s.tobytes(), name
        seen += 1
    assert seen == 4 + 10 * TDCFG.num_layers


def test_factory_builds_fp8_wan22_pipeline_from_a_moe_directory(tmp_path):
    root = str(tmp_path / "a14b")
    _, _, vae, t5 = _moe_dir(root)
    assert factory.is_wan22_moe_dir(root) and not factory.is_vae22_dir(root)
    from videocof_tpu.factory import is_wan22_moe_dir as jis_moe
    assert jis_moe(root)
    loras = [(_lora_file(str(tmp_path / "l.safetensors"), 5), 0.7)]
    pipe = factory.load_pipeline(root, dtype=torch.float32, vae_cfg=TVCFG,
                                 t5_cfg=TT5CFG, require_real_tokenizer=False,
                                 quantize="fp8", lora_paths=loras,
                                 device="cpu")
    assert isinstance(pipe, Wan22Pipeline) and pipe.boundary == 0.875
    assert pipe.vae_decode_chunk == 2
    for dit, sub in ((pipe.dit, factory.LOW_NOISE_SUBPATH),
                     (pipe.dit_2, factory.HIGH_NOISE_SUBPATH)):
        assert dit.cfg == TDCFG
        _assert_fp8_equal(dit, _jax_expert(os.path.join(root, sub), loras))
    # the VAE and umT5 as JAX's converters read them
    jv = convert.vae_from_jax(jax.tree.map(np.asarray, jweights.
        convert_vae_state_dict(jweights.load_state_dict(os.path.join(
            root, factory.VAE_SUBPATH)), J_VAE)))
    jt = convert.t5_from_jax(jax.tree.map(np.asarray, jweights.
        convert_t5_state_dict(jweights.load_state_dict(os.path.join(
            root, factory.T5_SUBPATH)), J_T5)))
    # (and as written: the exports invert the converters)
    for module, want, written in ((pipe.vae, jv, vae), (pipe.t5, jt, t5)):
        for k, v in module.state_dict().items():
            assert torch.equal(v, want[k]), k
            assert torch.equal(v, written.state_dict()[k]), k


def test_factory_high_noise_model_argument(tmp_path):
    root = str(tmp_path / "a14b")
    dit, dit2, _, _ = _moe_dir(root)
    low = os.path.join(root, factory.LOW_NOISE_SUBPATH)
    # the base expert's directory alone, the VAE and umT5 beside it
    for name in (factory.VAE_SUBPATH, factory.T5_SUBPATH):
        os.link(os.path.join(root, name), os.path.join(low, name))
    pipe = factory.load_pipeline(
        low, dtype=torch.float32, vae_cfg=TVCFG, t5_cfg=TT5CFG,
        require_real_tokenizer=False, device="cpu", boundary=0.9,
        high_noise_model=os.path.join(root, factory.HIGH_NOISE_SUBPATH))
    assert isinstance(pipe, Wan22Pipeline) and pipe.boundary == 0.9
    for got, want in ((pipe.dit, dit), (pipe.dit_2, dit2)):
        for k, v in want.state_dict().items():
            assert torch.equal(got.state_dict()[k], v), k
    one = factory.load_pipeline(low, dtype=torch.float32, vae_cfg=TVCFG,
                                t5_cfg=TT5CFG, require_real_tokenizer=False,
                                device="cpu")
    assert type(one) is WanPipeline


def test_factory_random_init_refuses_high_noise_model_and_quantizes():
    with pytest.raises(ValueError, match="high_noise_model"):
        factory.load_pipeline("", random_init=True, device="cpu",
                              high_noise_model="x")
    with pytest.raises(ValueError, match="quantize"):
        factory.load_pipeline("", random_init=True, device="cpu",
                              quantize="int4")
    pipe = factory.load_pipeline("", dtype=torch.float32, random_init=True,
                                 dit_cfg=TDCFG, vae_cfg=TVCFG, t5_cfg=TT5CFG,
                                 seed=5, quantize="fp8", device="cpu")
    want = quantize_dit_fp8(init_wan_dit(TDCFG,
                                         torch.Generator().manual_seed(5)))
    for k, v in want.state_dict().items():
        got = pipe.dit.state_dict()[k]
        assert got.dtype == v.dtype and torch.equal(
            got.view(torch.uint8) if got.dtype == torch.float8_e4m3fn
            else got, v.view(torch.uint8) if v.dtype == torch.float8_e4m3fn
            else v), k
    assert is_fp8(pipe.dit.blocks[0].self_attn.q)


@dataclasses.dataclass(frozen=True)
class _Tiny22(Wan22VAEConfig):
    """`Wan22VAEConfig` whose defaults are `WAN22_VAE_TINY`'s."""
    dim: int = WAN22_VAE_TINY.dim
    dec_dim: int = WAN22_VAE_TINY.dec_dim
    z_dim: int = WAN22_VAE_TINY.z_dim
    dim_mult: tuple = WAN22_VAE_TINY.dim_mult
    num_res_blocks: int = WAN22_VAE_TINY.num_res_blocks
    latent_mean: tuple = WAN22_VAE_TINY.latent_mean
    latent_std: tuple = WAN22_VAE_TINY.latent_std


def test_factory_reads_a_ti2v_5b_directory(tmp_path, monkeypatch):
    root = str(tmp_path / "ti2v")
    dcfg = TDCFG.replace(in_dim=WAN22_VAE_TINY.z_dim,
                         out_dim=WAN22_VAE_TINY.z_dim)
    dit = _filled(WanDiT(dcfg), 6)
    vae = _filled(Wan22VAE(WAN22_VAE_TINY), 7)
    checkpoint.save_wan_checkpoint_dir(root, dit, vae,
                                       _filled(T5Encoder(TT5CFG), 8))
    assert factory.is_vae22_dir(root) and not factory.is_wan22_moe_dir(root)
    from videocof_tpu.factory import is_vae22_dir as jis_vae22
    assert jis_vae22(root)
    # the factory's default Wan2.2 VAE config, at the tiny widths
    monkeypatch.setattr(factory, "Wan22VAEConfig", _Tiny22)
    pipe = factory.load_pipeline(root, dtype=torch.float32, t5_cfg=TT5CFG,
                                 require_real_tokenizer=False, device="cpu")
    assert type(pipe) is WanPipeline and isinstance(pipe.vae, Wan22VAE)
    assert isinstance(pipe.vae.cfg, _Tiny22)
    want = convert.vae_from_jax(jax.tree.map(np.asarray,
        jv22.convert_wan22_vae_state_dict(jweights.load_state_dict(
            os.path.join(root, factory.VAE22_SUBPATH)), jv22.WAN22_VAE_TINY)))
    for k, v in pipe.vae.state_dict().items():
        assert torch.equal(v, want[k]), k
        assert torch.equal(v, vae.state_dict()[k]), k
    for k, v in dit.state_dict().items():
        assert torch.equal(pipe.dit.state_dict()[k], v), k


@pytest.mark.parametrize("cli_pair", ["fast_infer", "infer"])
def test_quantize_fp8_reaches_the_factory(tmp_path, monkeypatch, cli_pair):
    port_cli, jax_cli = {"fast_infer": (fast_infer, jcli),
                         "infer": (infer, jinfer)}[cli_pair]
    argv = ["--video_path", "v.mp4", "--prompt", "x", "--output_dir",
            str(tmp_path), "--random_init", "--quantize", "fp8"]
    monkeypatch.setattr(sys, "argv", [cli_pair] + argv)
    assert vars(port_cli.parse_args(argv)) == vars(jax_cli.parse_args())
    seen = {}

    def load(model_name, **kw):
        seen.update(kw)
        raise RuntimeError("stop after the factory's arguments")
    monkeypatch.setattr(factory, "load_pipeline", load)
    with pytest.raises(RuntimeError, match="stop"):
        common.build_pipeline_from_args(port_cli.parse_args(argv))
    assert seen["quantize"] == "fp8" and seen["random_init"]


# ------------------------------------------------------------ --t2v entries

@pytest.fixture(scope="module")
def moe_pipelines():
    as_np = lambda p: jax.tree.map(np.asarray, p)  # noqa: E731
    dp = jdit.init_wan_dit(jax.random.PRNGKey(0), DCFG)
    dp2 = jdit.init_wan_dit(jax.random.PRNGKey(3), DCFG)
    vp = jvae.init_wan_vae(jax.random.PRNGKey(1), J_VAE)
    tp = jt5.init_t5_encoder(jax.random.PRNGKey(2), J_T5)
    jpipe = JaxWan22(dp, DCFG, vp, J_VAE, tp, J_T5, dtype=jnp.float32,
                     dit_params_2=dp2)

    def dit(params):
        m = WanDiT(TDCFG)
        m.load_state_dict(convert.dit_from_jax(as_np(params)))
        return m
    vae = WanVAE(TVCFG)
    vae.load_state_dict(convert.vae_from_jax(as_np(vp)))
    t5 = T5Encoder(TT5CFG)
    t5.load_state_dict(convert.t5_from_jax(as_np(tp)))
    return jpipe, Wan22Pipeline(dit(dp), vae, t5, dtype=torch.float32,
                                device="cpu", dit_2=dit(dp2))


class _T2VCapture:
    """A pipeline whose `text_to_video` calls get the same ``noise`` and
    keep their arguments and outputs; the expert attribute each CLI looks
    for is passed through."""

    def __init__(self, pipe, noise, **extra):
        self.pipe, self.noise, self.extra = pipe, noise, extra
        self.dit_2 = getattr(pipe, "dit_2", None)
        self.dit_params_2 = getattr(pipe, "dit_params_2", None)
        self.kwargs, self.outputs = [], []

    def text_to_video(self, prompt, **kw):
        self.kwargs.append(kw)
        out = self.pipe.text_to_video(prompt, noise=self.noise,
                                      output_latents=True, **self.extra, **kw)
        self.outputs.append(out)
        return out


@pytest.mark.parametrize("cli_pair", ["fast_infer", "infer"])
def test_t2v_cli_matches_jax(moe_pipelines, tmp_path, monkeypatch,
                             cli_pair):
    monkeypatch.setenv("VIDEOCOF_STEPWISE", "1")
    monkeypatch.setenv("VIDEOCOF_FETCH_YUV420", "0")
    port_cli, jax_cli = {"fast_infer": (fast_infer, jcli),
                         "infer": (infer, jinfer)}[cli_pair]
    jpipe, pipe = moe_pipelines
    noise = np.random.default_rng(3).standard_normal(
        (1, J_VAE.z_dim, 3, 4, 4)).astype(np.float32)
    caps = {"jax": _T2VCapture(jpipe, noise, fused_sampling=False),
            "port": _T2VCapture(pipe, noise)}
    saved = {}
    for side, module, cli_module in (("jax", jcommon, jax_cli),
                                     ("port", common, port_cli)):
        out_dir = str(tmp_path / side)
        real = module.save_results
        saved[side] = {}

        def save_results(video, path, fps=16, side=side, real=real):
            saved[side][os.path.basename(path)] = np.asarray(video)
            real(video, path, fps)
        monkeypatch.setattr(module, "save_results", save_results)
        for m in (module, cli_module):
            monkeypatch.setattr(m, "build_pipeline_from_args",
                                lambda args, cap=caps[side], **kw: cap)
        argv = ["--t2v", "--prompt", PROMPT, "--output_dir", out_dir,
                "--random_init", "--height", "32", "--width", "32",
                "--num_frames", "9", "--num_inference_steps", "4",
                "--guidance_scale", "3.0", "--guidance_scale_2", "2.0",
                "--shift", "5", "--seed", "3", "--quantize", "fp8"]
        monkeypatch.setattr(sys, "argv", [cli_pair] + argv)
        result = cli_module.main() if side == "jax" else cli_module.main(argv)
    slug = "".join(c if c.isalnum() else "_" for c in PROMPT.lower())[:48]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax")) == [f"gen_{slug}.mp4",
                                          f"gen_{slug}_info.txt"]
    assert set(result) == {f"{slug}.mp4"}
    kw, jkw = caps["port"].kwargs[0], caps["jax"].kwargs[0]
    assert kw["guidance_scale_2"] == jkw["guidance_scale_2"] == 2.0
    for key in ("height", "width", "num_frames", "num_inference_steps",
                "guidance_scale", "shift", "negative_prompt"):
        assert kw[key] == jkw[key], key
    np.testing.assert_allclose(caps["port"].outputs[0].latents,
                               caps["jax"].outputs[0].latents, rtol=2e-4,
                               atol=2e-4)
    got, want = saved["port"], saved["jax"]
    assert set(got) == set(want) == {f"gen_{slug}.mp4"}
    assert got[f"gen_{slug}.mp4"].shape == (1, 3, 9, 32, 32)
    assert np.abs(got[f"gen_{slug}.mp4"] - want[f"gen_{slug}.mp4"]
                  ).max() * 255 <= 1.0 + 1e-3
