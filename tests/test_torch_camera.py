"""Camera control in the port against the JAX package on the CPU: the
temporal packing, the adapter and its state-dict converter, the DiT with
``y_camera``, `camera_to_video` and the factory's detection of a camera
checkpoint, with the same weights (carried by `videocof_torch.convert`),
pose rows and noise."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videocof_tpu.configs import T5_TINY as J_T5, VAE_TINY as J_VAE
from videocof_tpu.configs import WAN_TINY as J_WAN
from videocof_tpu.models import camera_adapter as jca
from videocof_tpu.models import t5_encoder as jt5, wan_dit as jdit
from videocof_tpu.models import wan_vae as jvae
from videocof_tpu.pipeline import CameraPipeline as JaxCamera
from videocof_tpu.pipeline.camera_pipeline import (
    convert_camera_adapter_state_dict as jconvert, pack_camera_frames as jpack)
from videocof_torch import convert, factory
from videocof_torch.configs import T5Config, WanDiTConfig, WanVAEConfig
from videocof_torch.models import camera_adapter as ca
from videocof_torch.models.t5_encoder import T5Encoder
from videocof_torch.models.wan_dit import WanDiT
from videocof_torch.models.wan_vae import WanVAE
from videocof_torch.pipeline import CameraPipeline
from videocof_torch.pipeline.camera_pipeline import (
    convert_camera_adapter_state_dict, export_camera_adapter_state_dict,
    pack_camera_frames)
from videocof_torch.utils import checkpoint

from _published_layouts import t5_published_name, vae_published_name

torch.set_num_threads(1)

as_np = lambda p: jax.tree.map(np.asarray, p)  # noqa: E731
DCFG = J_WAN.replace(in_dim=J_VAE.z_dim, out_dim=J_VAE.z_dim,
                     text_dim=J_T5.dim)
TDCFG = convert.config_from(WanDiTConfig, DCFG)
TVCFG = convert.config_from(WanVAEConfig, J_VAE)
TT5CFG = convert.config_from(T5Config, J_T5)
PROMPT = "a slow truck to the right"


def _pose_rows(n=9):
    rows = []
    for i in range(n):
        w2c = np.eye(4)[:3].copy()
        w2c[0, 3] = 0.05 * i
        w2c[1, 3] = -0.02 * i
        rows.append([float(i), 0.8, 0.9, 0.5, 0.5, 0.0, 0.0,
                     *w2c.reshape(-1).tolist()])
    return rows


def _adapter_pair(seed, out_dim, n_res=1):
    params = jca.init_camera_adapter(jax.random.PRNGKey(seed), in_dim=24,
                                     out_dim=out_dim,
                                     num_residual_blocks=n_res)
    # non-zero biases, so that the converter's bias paths are held too
    params = jax.tree.map(lambda a: a + 0.01, params)
    adapter = ca.CameraAdapter(24, out_dim, num_residual_blocks=n_res)
    adapter.load_state_dict(convert.camera_adapter_from_jax(as_np(params)))
    return params, adapter


@pytest.fixture(scope="module")
def pipes():
    dp = jdit.init_wan_dit(jax.random.PRNGKey(0), DCFG)
    vp = jvae.init_wan_vae(jax.random.PRNGKey(1), J_VAE)
    tp = jt5.init_t5_encoder(jax.random.PRNGKey(2), J_T5)
    cp, adapter = _adapter_pair(3, DCFG.dim)
    jpipe = JaxCamera(dp, DCFG, vp, J_VAE, tp, J_T5, dtype=jnp.float32,
                      camera_params=cp)
    dit = WanDiT(TDCFG)
    dit.load_state_dict(convert.dit_from_jax(as_np(dp)))
    vae = WanVAE(TVCFG)
    vae.load_state_dict(convert.vae_from_jax(as_np(vp)))
    t5 = T5Encoder(TT5CFG)
    t5.load_state_dict(convert.t5_from_jax(as_np(tp)))
    return jpipe, CameraPipeline(dit, vae, t5, dtype=torch.float32,
                                 device="cpu", camera=adapter)


@pytest.mark.parametrize("frames", [9, 13, 1])
def test_pack_camera_frames_matches_jax(frames):
    rays = np.random.default_rng(0).standard_normal(
        (2, 6, frames, 8, 8)).astype(np.float32)
    want = np.asarray(jpack(jnp.asarray(rays), 4))
    got = pack_camera_frames(torch.from_numpy(rays), 4).numpy()
    np.testing.assert_array_equal(got, want)


def test_pack_camera_frames_names_the_fix():
    with pytest.raises(ValueError, match="9 or 13"):
        pack_camera_frames(torch.zeros(1, 6, 10, 8, 8), 4)


@pytest.mark.parametrize("n_res", [1, 2])
def test_camera_adapter_forward_matches_jax(n_res):
    """Pixel-unshuffle, stride-2 conv, residual blocks: 1e-5 relative to
    the features' scale (fp32)."""
    params, adapter = _adapter_pair(4, 64, n_res)
    x = np.random.default_rng(1).standard_normal((2, 24, 3, 32, 48)).astype(
        np.float32)
    want = np.asarray(jca.camera_adapter_forward(params, jnp.asarray(x)))
    with torch.no_grad():
        got = ca.camera_adapter_forward(adapter, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 64, 3, 2, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(
        torch.nn.functional.pixel_unshuffle(torch.from_numpy(x[:, :, 0]),
                                            8).numpy(),
        np.asarray(jca.pixel_unshuffle(jnp.asarray(x[:, :, 0]), 8)))


def test_camera_adapter_converter_matches_jax():
    """``control_adapter.*`` keys: bit for bit JAX's converter (then
    `camera_adapter_from_jax`), and back through the port's exporter."""
    _, adapter = _adapter_pair(5, 32, 2)
    sd = export_camera_adapter_state_dict(adapter.state_dict())
    assert "control_adapter.residual_blocks.1.conv2.bias" in sd
    want = convert.camera_adapter_from_jax(as_np(jconvert(
        {k: v.numpy() for k, v in sd.items()})))
    got = convert_camera_adapter_state_dict({**sd, "blocks.0.x": None})
    assert set(got) == set(want) == set(adapter.state_dict())
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_dit_with_y_camera_matches_jax():
    """The camera features added onto the patch embeddings: 1e-4 relative
    to the velocity's scale."""
    rng = np.random.default_rng(2)
    dp = jdit.init_wan_dit(jax.random.PRNGKey(6), DCFG)
    dit = WanDiT(TDCFG)
    dit.load_state_dict(convert.dit_from_jax(as_np(dp)))
    x = rng.standard_normal((2, J_VAE.z_dim, 3, 8, 8)).astype(np.float32)
    cam = rng.standard_normal((2, DCFG.dim, 3, 4, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 16, J_T5.dim)).astype(np.float32)
    t = np.array([800.0, 30.0], np.float32)
    cos, sin = jdit.make_rope_for_geometry(DCFG, (3, 4, 4))
    want, _ = jdit.wan_dit_forward_with_residual(
        dp, DCFG, *(jnp.asarray(a) for a in (x, t, ctx, cos, sin)),
        y_camera=jnp.asarray(cam))
    with torch.no_grad():
        got = dit(*(torch.from_numpy(a) for a in (x, t, ctx, cos, sin)),
                  y_camera=torch.from_numpy(cam)).numpy()
        plain = dit(*(torch.from_numpy(a) for a in (x, t, ctx, cos, sin)))
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    assert np.abs(plain.numpy() - got).max() > 1e-3


@pytest.mark.parametrize("guidance", [1.0, 5.0])
def test_camera_to_video_matches_jax(pipes, guidance):
    """Pose rows -> Plücker rays -> adapter -> ``y_camera`` through the
    trajectory: the camera features within 1e-5, the latents within 2e-4,
    the frames within one uint8 level."""
    jpipe, pipe = pipes
    rows = _pose_rows()
    np.testing.assert_allclose(
        pipe.prepare_camera_features(rows, 32, 32).numpy(),
        np.asarray(jpipe.prepare_camera_features(rows, 32, 32)),
        rtol=1e-5, atol=1e-5)
    noise = np.random.default_rng(3).standard_normal(
        (1, J_VAE.z_dim, 3, 4, 4)).astype(np.float32)
    kw = dict(height=32, width=32, num_frames=9, num_inference_steps=2,
              guidance_scale=guidance, negative_prompt="static",
              max_sequence_length=16, noise=noise, output_latents=True)
    want = jpipe.camera_to_video(PROMPT, rows, **kw)
    timings = {}
    got = pipe.camera_to_video(PROMPT, rows, timings=timings, **kw)
    assert set(timings) == {"text", "camera+latents", "step0", "step1",
                            "decode"}
    np.testing.assert_allclose(got.latents, want.latents, rtol=2e-4,
                               atol=2e-4)
    assert np.abs(got.videos - want.videos).max() * 255 <= 1.0 + 1e-3
    with pytest.raises(ValueError, match="pose rows"):
        pipe.camera_to_video(PROMPT, _pose_rows(5), **kw)


def test_factory_detects_a_camera_checkpoint(tmp_path):
    """A directory whose DiT holds ``control_adapter.*`` keys gives a
    `CameraPipeline` holding the adapter written."""
    rng = np.random.default_rng(4)
    fill = lambda m: m.load_state_dict({  # noqa: E731
        k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(
            np.float32)) for k, v in m.state_dict().items()})
    dit, adapter = WanDiT(TDCFG), ca.CameraAdapter(24, TDCFG.dim)
    fill(dit)
    fill(adapter)
    root = str(tmp_path)
    checkpoint.save_dit_checkpoint_dir(
        root, dit, TDCFG,
        extra=export_camera_adapter_state_dict(adapter.state_dict()))
    fill_sd = lambda m: {k: torch.from_numpy(rng.standard_normal(  # noqa
        tuple(v.shape)).astype(np.float32)) for k, v in m.state_dict().items()}
    torch.save({vae_published_name(k, TVCFG): v
                for k, v in fill_sd(WanVAE(TVCFG)).items()},
               os.path.join(root, factory.VAE_SUBPATH))
    torch.save({t5_published_name(k): v
                for k, v in fill_sd(T5Encoder(TT5CFG)).items()},
               os.path.join(root, factory.T5_SUBPATH))
    with open(os.path.join(root, "config.json")) as f:
        assert json.load(f)["model_type"] == "t2v"
    pipe = factory.load_pipeline(root, dtype=torch.float32, vae_cfg=TVCFG,
                                 t5_cfg=TT5CFG, require_real_tokenizer=False,
                                 device="cpu")
    assert isinstance(pipe, CameraPipeline)
    for mine, want in ((pipe.dit, dit), (pipe.camera, adapter)):
        for k, v in want.state_dict().items():
            assert torch.equal(mine.state_dict()[k], v), k
