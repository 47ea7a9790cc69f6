"""VACE control-to-video in the port against the JAX package on the CPU:
the hint branch's forward at strides 1, 2 and 3, its state-dict converter,
`patchify_mask`, the control context, `control_to_video`, the zero-init
branch against the plain text-to-video trajectory, the factory's detection
of a VACE checkpoint and the CLI's ``--control_video`` item, with the same
weights (carried by `videocof_torch.convert`), inputs and noise; and the
runtime LoRA adapters the port's forward fuses into the base blocks,
against JAX's forward on the same LoRA merged (a departure: JAX's forward
skips them)."""

import os
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videocof_tpu.cli._common as jcommon
import videocof_tpu.cli.fast_infer as jcli
import videocof_tpu.runtime as jruntime
from videocof_tpu.configs import T5_TINY as J_T5, VAE_TINY as J_VAE
from videocof_tpu.configs import WAN_TINY as J_WAN
from videocof_tpu.models import lora as jlora
from videocof_tpu.models import t5_encoder as jt5, wan_dit as jdit
from videocof_tpu.models import wan_dit_vace as jvace
from videocof_tpu.models import wan_vae as jvae
from videocof_tpu.pipeline import VacePipeline as JaxVace
from videocof_tpu.pipeline.vace_pipeline import patchify_mask as jpatchify
from videocof_torch import convert, factory
from videocof_torch.cli import _common as common
from videocof_torch.cli import fast_infer as cli
from videocof_torch.configs import T5Config, WanDiTConfig, WanVAEConfig
from videocof_torch.models import wan_dit_vace as vace_mod
from videocof_torch.models.t5_encoder import T5Encoder
from videocof_torch.models.wan_dit import WanDiT
from videocof_torch.models.wan_vae import WanVAE
from videocof_torch.pipeline import VacePipeline
from videocof_torch.pipeline.vace_pipeline import patchify_mask
from videocof_torch.utils import checkpoint, fp8

from _lora_files import kohya_lora, runtime_lora
from _published_layouts import t5_published_name, vae_published_name

torch.set_num_threads(1)

as_np = lambda p: jax.tree.map(np.asarray, p)  # noqa: E731
DCFG = J_WAN.replace(in_dim=J_VAE.z_dim, out_dim=J_VAE.z_dim,
                     text_dim=J_T5.dim)
TDCFG = convert.config_from(WanDiTConfig, DCFG)
TVCFG = convert.config_from(WanVAEConfig, J_VAE)
TT5CFG = convert.config_from(T5Config, J_T5)
SC = J_VAE.spatial_compression_ratio
VACE_IN = 2 * J_VAE.z_dim + SC * SC
PROMPT = "a red cube rotating"


def _live(vp, key):
    """``vp`` with random (non-zero) before/after projections, so that the
    hints reach the base stream."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(key))
    vp = dict(vp)
    vp["after_proj"] = {"kernel": 0.05 * jax.random.normal(
        k1, vp["after_proj"]["kernel"].shape),
        "bias": 0.01 * jnp.ones_like(vp["after_proj"]["bias"])}
    vp["before_proj"] = {"kernel": 0.1 * jax.random.normal(
        k2, vp["before_proj"]["kernel"].shape),
        "bias": vp["before_proj"]["bias"]}
    return vp


def _port_vace(vp, cfg, stride):
    vace = vace_mod.WanVace(cfg, stride, VACE_IN)
    vace.load_state_dict(convert.vace_from_jax(as_np(vp)))
    return vace


@pytest.fixture(scope="module")
def pipes():
    dp = jdit.init_wan_dit(jax.random.PRNGKey(0), DCFG)
    vp = jvae.init_wan_vae(jax.random.PRNGKey(1), J_VAE)
    tp = jt5.init_t5_encoder(jax.random.PRNGKey(2), J_T5)
    cp = _live(jvace.init_vace_params(jax.random.PRNGKey(3), DCFG, stride=2,
                                      vace_in_dim=VACE_IN), 4)
    jpipe = JaxVace(dp, DCFG, vp, J_VAE, tp, J_T5, dtype=jnp.float32,
                    vace_params=cp, vace_stride=2)
    dit = WanDiT(TDCFG)
    dit.load_state_dict(convert.dit_from_jax(as_np(dp)))
    vae = WanVAE(TVCFG)
    vae.load_state_dict(convert.vae_from_jax(as_np(vp)))
    t5 = T5Encoder(TT5CFG)
    t5.load_state_dict(convert.t5_from_jax(as_np(tp)))
    pipe = VacePipeline(dit, vae, t5, dtype=torch.float32, device="cpu",
                        vace=_port_vace(cp, TDCFG, 2))
    return jpipe, pipe


@pytest.fixture(scope="module")
def control():
    return np.random.default_rng(0).uniform(-1, 1, (1, 3, 9, 32, 32)).astype(
        np.float32)


def test_patchify_mask_matches_jax():
    mask = np.random.default_rng(1).integers(0, 2, (2, 1, 9, 32, 32)).astype(
        np.float32)
    for t_latent in (3, 2, 5):
        want = np.asarray(jpatchify(jnp.asarray(mask), SC, t_latent))
        got = patchify_mask(torch.from_numpy(mask), SC, t_latent).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layers,stride", [(2, 2), (2, 1), (6, 3)])
def test_vace_forward_matches_jax(layers, stride):
    """The hint branch at stride 2 (1 hint block of 2 layers), 1 and 3
    (6 layers, 2 hints), live projections, context scale 0.7: 1e-4 relative
    to the velocity's scale (fp32)."""
    cfg = DCFG.replace(num_layers=layers)
    tcfg = convert.config_from(WanDiTConfig, cfg)
    dp = jdit.init_wan_dit(jax.random.PRNGKey(5), cfg)
    cp = _live(jvace.init_vace_params(jax.random.PRNGKey(6), cfg,
                                      stride=stride, vace_in_dim=VACE_IN), 7)
    dit = WanDiT(tcfg)
    dit.load_state_dict(convert.dit_from_jax(as_np(dp)))
    vace = _port_vace(cp, tcfg, stride)
    assert vace.n_vace == layers // stride
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, J_VAE.z_dim, 3, 8, 8)).astype(np.float32)
    vc = rng.standard_normal((2, VACE_IN, 3, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((2, 16, J_T5.dim)).astype(np.float32)
    t = np.array([700.0, 80.0], np.float32)
    cos, sin = jdit.make_rope_for_geometry(cfg, (3, 4, 4))
    want = np.asarray(jvace.vace_forward(
        dp, cp, cfg, jnp.asarray(x), jnp.asarray(vc), jnp.asarray(t),
        jnp.asarray(ctx), jnp.asarray(cos), jnp.asarray(sin),
        context_scale=0.7, stride=stride))
    with torch.no_grad():
        got = vace_mod.vace_forward(
            dit, vace, *(torch.from_numpy(a) for a in (x, vc, t, ctx, cos,
                                                       sin)),
            context_scale=0.7).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def _published_vace(cfg, stride, rng):
    """A `VaceWanTransformer3DModel` state dict drawn with numpy, written by
    the port's exporters; and the port's modules holding it."""
    fill = lambda m: m.load_state_dict({  # noqa: E731
        k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(
            np.float32)) for k, v in m.state_dict().items()})
    dit, vace = WanDiT(cfg), vace_mod.WanVace(cfg, stride, VACE_IN)
    fill(dit)
    fill(vace)
    sd = checkpoint.export_dit_state_dict(dit.state_dict(), cfg)
    sd.update(vace_mod.export_vace_state_dict(vace.state_dict(), cfg, stride))
    return dit, vace, sd


@pytest.mark.parametrize("stride", [1, 2])
def test_vace_state_dict_converter_matches_jax(stride):
    """Bit for bit JAX's converter (then `dit_from_jax`, `vace_from_jax`),
    and the stride read back from the keys."""
    dit, vace, sd = _published_vace(TDCFG, stride, np.random.default_rng(9))
    assert "vace_blocks.0.before_proj.weight" in sd
    assert vace_mod.vace_stride(sd, TDCFG) == stride
    jb, jv = jvace.convert_vace_state_dict(
        {k: v.numpy() for k, v in sd.items()}, DCFG, stride=stride)
    base, got = vace_mod.convert_vace_state_dict(sd, TDCFG, stride)
    for have, want, module in ((base, convert.dit_from_jax(as_np(jb)), dit),
                               (got, convert.vace_from_jax(as_np(jv)), vace)):
        assert set(have) == set(want) == set(module.state_dict())
        for k in want:
            assert torch.equal(have[k], want[k]), k
            assert torch.equal(have[k], module.state_dict()[k]), k


@pytest.mark.parametrize("masked", [False, True])
def test_prepare_vace_context_matches_jax(pipes, control, masked):
    """[inactive | reactive | mask] within 1e-5 (fp32); the mask channels
    bit for bit."""
    jpipe, pipe = pipes
    mask = None
    if masked:
        mask = np.zeros((1, 1, 9, 32, 32), np.float32)
        mask[..., 8:24, 4:20] = 1.0
    want = np.asarray(jpipe.prepare_vace_context(control, mask))
    got = pipe.prepare_vace_context(control, mask).numpy()
    assert got.shape == want.shape == (1, VACE_IN, 3, 4, 4)
    np.testing.assert_array_equal(got[:, 2 * J_VAE.z_dim:],
                                  want[:, 2 * J_VAE.z_dim:])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("guidance,scale", [(1.0, 1.0), (4.0, 0.6)])
def test_control_to_video_matches_jax(pipes, control, guidance, scale):
    """End to end with a region mask, live hints and the same noise: the
    latents within 2e-4, the frames within one uint8 level."""
    jpipe, pipe = pipes
    rng = np.random.default_rng(10)
    noise = rng.standard_normal((1, J_VAE.z_dim, 3, 4, 4)).astype(np.float32)
    mask = (rng.uniform(size=(1, 1, 9, 32, 32)) > 0.5).astype(np.float32)
    video = ((control + 1) * 127.5).astype(np.uint8)
    kw = dict(mask=mask, num_inference_steps=2, guidance_scale=guidance,
              context_scale=scale, negative_prompt="blurry",
              max_sequence_length=16, noise=noise, output_latents=True)
    want = jpipe.control_to_video(PROMPT, video, **kw)
    timings = {}
    got = pipe.control_to_video(PROMPT, video, timings=timings, **kw)
    assert set(timings) == {"text", "encode+latents", "step0", "step1",
                            "decode"}
    assert got.videos.shape == want.videos.shape == (1, 3, 9, 32, 32)
    np.testing.assert_allclose(got.latents, want.latents, rtol=2e-4,
                               atol=2e-4)
    assert np.abs(got.videos - want.videos).max() * 255 <= 1.0 + 1e-3


def test_zero_init_branch_is_the_t2v_trajectory(pipes, control):
    """A fresh branch (`init_vace_params`: zero projections) leaves the
    plain text-to-video trajectory as it is (JAX's own property)."""
    _, live = pipes
    vace = vace_mod.init_vace_params(
        TDCFG, torch.Generator().manual_seed(0), stride=2, vace_in_dim=VACE_IN)
    pipe = VacePipeline(live.dit, live.vae, live.t5, dtype=torch.float32,
                        device="cpu", vace=vace)
    noise = np.random.default_rng(11).standard_normal(
        (1, J_VAE.z_dim, 3, 4, 4)).astype(np.float32)
    kw = dict(num_inference_steps=2, guidance_scale=1.0, noise=noise,
              output_latents=True, max_sequence_length=16)
    a = pipe.control_to_video(PROMPT, control, **kw)
    b = pipe.text_to_video(PROMPT, height=32, width=32, num_frames=9, **kw)
    np.testing.assert_allclose(a.latents, b.latents, rtol=1e-6, atol=1e-6)
    c = live.control_to_video(PROMPT, control, **kw)
    assert np.abs(c.latents - b.latents).max() > 1e-4


def _write_dir(root, stride, rng):
    dit, vace, sd = _published_vace(TDCFG, stride, rng)
    checkpoint.write_safetensors(os.path.join(
        root, "diffusion_pytorch_model.safetensors"), sd)
    with open(os.path.join(root, "config.json"), "w") as f:
        import json
        json.dump(checkpoint.dit_checkpoint_config(TDCFG), f)
    fill = lambda m: {k: torch.from_numpy(rng.standard_normal(  # noqa: E731
        tuple(v.shape)).astype(np.float32)) for k, v in m.state_dict().items()}
    torch.save({vae_published_name(k, TVCFG): v
                for k, v in fill(WanVAE(TVCFG)).items()},
               os.path.join(root, factory.VAE_SUBPATH))
    torch.save({t5_published_name(k): v
                for k, v in fill(T5Encoder(TT5CFG)).items()},
               os.path.join(root, factory.T5_SUBPATH))
    return dit, vace


@pytest.mark.parametrize("stride", [1, 2])
def test_factory_detects_a_vace_checkpoint(tmp_path, stride):
    """A directory whose DiT holds ``vace_*`` keys gives a `VacePipeline`
    with the stride its hint blocks imply and the weights written."""
    dit, vace = _write_dir(str(tmp_path), stride, np.random.default_rng(12))
    pipe = factory.load_pipeline(str(tmp_path), dtype=torch.float32,
                                 vae_cfg=TVCFG, t5_cfg=TT5CFG,
                                 require_real_tokenizer=False, device="cpu")
    assert isinstance(pipe, VacePipeline) and pipe.vace.stride == stride
    for mine, want in ((pipe.dit, dit), (pipe.vace, vace)):
        for k, v in want.state_dict().items():
            assert torch.equal(mine.state_dict()[k], v), k


@pytest.fixture
def control_clip(tmp_path):
    path = str(tmp_path / "ctrl.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (32, 32))
    rng = np.random.default_rng(13)
    for _ in range(12):
        w.write(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8))
    w.release()
    return path


def test_cli_control_video_matches_jax(pipes, control_clip, tmp_path,
                                       monkeypatch):
    """``fast_infer --control_video`` (with ``--control_mask`` from the same
    clip) in both packages, on tiny pipelines of the same weights and
    noise: the saved videos within one uint8 level."""
    jpipe, pipe = pipes
    monkeypatch.setattr(jruntime, "_load", lambda: None)
    noise = np.random.default_rng(14).standard_normal(
        (1, J_VAE.z_dim, 3, 4, 4)).astype(np.float32)
    saved = {}
    for tag, p, mod, main in (("jax", jpipe, jcommon, jcli),
                              ("port", pipe, common, cli)):
        real = p.control_to_video
        monkeypatch.setattr(p, "control_to_video",
                            lambda *a, _r=real, **k: _r(*a, noise=noise, **k))
        monkeypatch.setattr(mod, "save_results",
                            lambda v, path, fps=16, _t=tag: saved.setdefault(
                                (_t, os.path.basename(path)), np.asarray(v)))
        for m in (mod, main):
            monkeypatch.setattr(m, "build_pipeline_from_args",
                                lambda args, _p=p, **kw: _p)
        monkeypatch.setattr(sys, "argv", [
            "fast_infer", "--control_video", control_clip, "--control_mask",
            control_clip, "--prompt", PROMPT, "--output_dir",
            str(tmp_path / tag), "--num_frames", "9", "--vace_scale", "0.8",
            "--random_init", "--num_inference_steps", "2"])
        main.main()
    name = "gen_ctrl.mp4"
    got, want = saved[("port", name)], saved[("jax", name)]
    assert got.shape == want.shape == (1, 3, 9, 32, 32)
    assert np.abs(got - want).max() * 255 <= 1.0 + 1e-3
    assert open(tmp_path / "port" / "gen_ctrl_info.txt").read() == PROMPT


@pytest.mark.parametrize("layers,stride", [(2, 2), (6, 3)])
def test_departure_vace_runtime_lora_matches_jax_merged(layers, stride):
    """The port's `vace_forward` fuses the DiT's ``runtime_lora`` into each
    base block (the hint blocks take none); JAX's skips it. The port with
    runtime adapters against JAX's forward on the same LoRA merged into the
    base weights (`merge_lora`): 1e-4 relative to the velocity's scale, as
    `test_vace_forward_matches_jax`; both far from the un-adapted
    forward."""
    cfg = DCFG.replace(num_layers=layers)
    tcfg = convert.config_from(WanDiTConfig, cfg)
    dp = jdit.init_wan_dit(jax.random.PRNGKey(12), cfg)
    cp = _live(jvace.init_vace_params(jax.random.PRNGKey(13), cfg,
                                      stride=stride, vace_in_dim=VACE_IN), 14)
    sd = kohya_lora(cfg, 15)
    merged = jlora.merge_lora(dp, cfg, sd, multiplier=0.8)
    dit = WanDiT(tcfg)
    dit.load_state_dict(convert.dit_from_jax(as_np(dp)))
    vace = _port_vace(cp, tcfg, stride)
    rng = np.random.default_rng(16)
    x = rng.standard_normal((2, J_VAE.z_dim, 3, 8, 8)).astype(np.float32)
    vc = rng.standard_normal((2, VACE_IN, 3, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((2, 16, J_T5.dim)).astype(np.float32)
    t = np.array([700.0, 80.0], np.float32)
    cos, sin = jdit.make_rope_for_geometry(cfg, (3, 4, 4))
    args = [x, vc, t, ctx, cos, sin]

    def jax_fwd(params):
        return np.asarray(jvace.vace_forward(
            params, cp, cfg, *(jnp.asarray(a) for a in args),
            context_scale=0.7, stride=stride))

    want, plain = jax_fwd(merged), jax_fwd(dp)
    with torch.no_grad():
        fwd = lambda: vace_mod.vace_forward(  # noqa: E731
            dit, vace, *(torch.from_numpy(np.asarray(a)) for a in args),
            context_scale=0.7).numpy()
        unadapted = fwd()
        dit.runtime_lora = runtime_lora(sd, tcfg, 0.8)
        got = fwd()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(unadapted, plain, rtol=1e-4,
                               atol=1e-4 * np.abs(plain).max())
    moved = np.linalg.norm(got - unadapted) / np.linalg.norm(unadapted)
    assert moved > 1e-2, moved


def test_departure_fp8_vace_pipeline_applies_runtime_lora(pipes, control):
    """An fp8 `VacePipeline` (as the factory builds one) under
    `set_runtime_lora`: its latents move from the plain fp8 pipeline's,
    and go back when the adapters are detached."""
    import copy
    _, live = pipes
    dit = fp8.quantize_dit_fp8(copy.deepcopy(live.dit))
    pipe = VacePipeline(dit, live.vae, live.t5, dtype=torch.bfloat16,
                        device="cpu", vace=copy.deepcopy(live.vace).to(
                            torch.bfloat16))
    noise = np.random.default_rng(17).standard_normal(
        (1, J_VAE.z_dim, 3, 4, 4)).astype(np.float32)
    kw = dict(num_inference_steps=2, guidance_scale=1.0, noise=noise,
              output_latents=True, max_sequence_length=16)
    plain = pipe.control_to_video(PROMPT, control, **kw).latents
    pipe.set_runtime_lora(runtime_lora(kohya_lora(DCFG, 18), TDCFG, 1.0))
    adapted = pipe.control_to_video(PROMPT, control, **kw).latents
    assert np.isfinite(adapted).all()
    moved = np.linalg.norm(adapted - plain) / np.linalg.norm(plain)
    assert moved > 1e-2, moved
    pipe.set_runtime_lora(None)
    np.testing.assert_array_equal(
        pipe.control_to_video(PROMPT, control, **kw).latents, plain)
