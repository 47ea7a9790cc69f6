"""Image-to-video in the port against the JAX package on the CPU: the CLIP
tower, its preprocessing and state-dict converter, the i2v DiT, the
conditioning builders and `image_to_video`, with the same weights (carried
by `videocof_torch.convert`), inputs and noise; and the two departures from
JAX (an i2v forward without CLIP features raises; CLIP sees the start image
in [-1, 1])."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from videocof_tpu.configs import T5_TINY as J_T5, VAE_TINY as J_VAE
from videocof_tpu.configs import WAN_TINY as J_WAN
from videocof_tpu.models import clip_vision as jcv
from videocof_tpu.models import t5_encoder as jt5, wan_dit as jdit
from videocof_tpu.models import wan_vae as jvae
from videocof_tpu.models import weights as jweights
from videocof_tpu.pipeline import WanPipeline as JaxPipeline
from videocof_tpu.utils import video_io as jvio
from videocof_torch import convert
from videocof_torch.configs import T5Config, WanDiTConfig, WanVAEConfig
from videocof_torch.models import clip_vision as cv
from videocof_torch.models import weights
from videocof_torch.models.t5_encoder import T5Encoder
from videocof_torch.models.wan_dit import WanDiT
from videocof_torch.models.wan_vae import WanVAE
from videocof_torch.pipeline import WanPipeline
from videocof_torch.utils import checkpoint
from videocof_torch.utils import video_io as vio

torch.set_num_threads(1)

as_np = lambda p: jax.tree.map(np.asarray, p)  # noqa: E731
DCFG = J_WAN.replace(model_type="i2v", in_dim=2 * J_VAE.z_dim + 4,
                     out_dim=J_VAE.z_dim, text_dim=J_T5.dim)
TDCFG = convert.config_from(WanDiTConfig, DCFG)
H = W = 32
FRAMES = 9
PROMPT = "make the scene move"
# CLIP_TINY's width is 32; the i2v DiT's image MLP takes 1280 features of
# 257 tokens, so the end-to-end CLIP path runs a one-block tower at 1280
CLIP_1280 = cv.ClipVisionConfig(dim=1280, num_heads=16, num_layers=1,
                                use_blocks=1)


def _clip_pair(jcfg, seed=0):
    params = jcv.init_clip_vision(jax.random.PRNGKey(seed), jcfg)
    tcfg = cv.ClipVisionConfig(**{f: getattr(jcfg, f) for f in (
        "image_size", "patch_size", "dim", "mlp_ratio", "num_heads",
        "num_layers", "use_blocks", "norm_eps")})
    model = cv.ClipVision(tcfg)
    model.load_state_dict(convert.clip_from_jax(as_np(params)))
    return params, model


@pytest.fixture(scope="module")
def pipes():
    dp = jdit.init_wan_dit(jax.random.PRNGKey(0), DCFG)
    vp = jvae.init_wan_vae(jax.random.PRNGKey(1), J_VAE)
    tp = jt5.init_t5_encoder(jax.random.PRNGKey(2), J_T5)
    jpipe = JaxPipeline(dp, DCFG, vp, J_VAE, tp, J_T5, dtype=jnp.float32)
    dit = WanDiT(TDCFG)
    dit.load_state_dict(convert.dit_from_jax(as_np(dp)))
    vae = WanVAE(convert.config_from(WanVAEConfig, J_VAE))
    vae.load_state_dict(convert.vae_from_jax(as_np(vp)))
    t5 = T5Encoder(convert.config_from(T5Config, J_T5))
    t5.load_state_dict(convert.t5_from_jax(as_np(tp)))
    return jpipe, WanPipeline(dit, vae, t5, dtype=torch.float32,
                              device="cpu")


@pytest.fixture(scope="module")
def start_image():
    return np.random.default_rng(0).integers(0, 256, (H, W, 3)
                                             ).astype(np.uint8)


# ------------------------------------------------------------------ CLIP

def test_clip_tower_matches_jax():
    """CLIP_TINY's forward, 1e-5 relative to the features' scale."""
    params, model = _clip_pair(jcv.CLIP_TINY)
    x = np.random.default_rng(1).standard_normal((2, 3, 28, 28)).astype(
        np.float32)
    want = np.asarray(jcv.clip_vision_forward(params, jcv.CLIP_TINY,
                                              jnp.asarray(x)))
    got = cv.clip_vision_forward(model, torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, 5, 32)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("hw,cfg", [((480, 832), jcv.CLIP_VIT_H_14),
                                    ((20, 36), jcv.CLIP_TINY),
                                    ((224, 300), jcv.CLIP_VIT_H_14)])
def test_clip_preprocess_matches_jax(hw, cfg):
    """The Keys-cubic resize (a = -0.5, antialiased when shrinking: 480x832
    -> 224x224), then the CLIP normalization: within 2e-5 absolute (one
    fp32 einsum order against another; the values reach about 2.2)."""
    x = np.random.default_rng(2).uniform(-1, 1, (1, 3) + hw).astype(
        np.float32)
    want = np.asarray(jcv.preprocess_frames(jnp.asarray(x), cfg))
    tcfg = cv.ClipVisionConfig(image_size=cfg.image_size)
    got = cv.preprocess_frames(torch.from_numpy(x), tcfg).numpy()
    assert got.shape == want.shape == (1, 3, cfg.image_size, cfg.image_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    # torch's own bicubic (a = -0.75, no antialiasing) is another function
    other = torch.nn.functional.interpolate(
        torch.from_numpy(x), (cfg.image_size,) * 2, mode="bicubic",
        align_corners=False)
    assert (other - cv.cubic_resize(torch.from_numpy(x),
                                    (cfg.image_size,) * 2)).abs().max() > 1e-2


def _published_clip(cfg, rng):
    """A state dict in the published layout (``visual.*``), drawn with
    numpy."""
    d, f, p = cfg.dim, cfg.dim * cfg.mlp_ratio, cfg.patch_size
    shapes = {"visual.patch_embedding.weight": (d, 3, p, p),
              "visual.cls_embedding": (1, 1, d),
              "visual.pos_embedding": (1, cfg.num_patches + 1, d),
              "visual.pre_norm.weight": (d,), "visual.pre_norm.bias": (d,)}
    for i in range(cfg.num_layers):
        b = f"visual.transformer.{i}."
        for name, shape in (("norm1", (d,)), ("norm2", (d,)),
                            ("attn.to_qkv", (3 * d, d)),
                            ("attn.proj", (d, d)), ("mlp.0", (f, d)),
                            ("mlp.2", (d, f))):
            shapes[b + name + ".weight"] = shape
            shapes[b + name + ".bias"] = shape[:1]
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("prefix", ["", "model."])
def test_clip_state_dict_converter_matches_jax(prefix):
    """Bit for bit JAX's converter (then `clip_from_jax`), with and without
    the reference wrapper's 'model.' prefix."""
    sd = {prefix + k: v for k, v in _published_clip(
        jcv.CLIP_TINY, np.random.default_rng(3)).items()}
    want = convert.clip_from_jax(as_np(jcv.convert_clip_state_dict(
        sd, jcv.CLIP_TINY)))
    got = cv.convert_clip_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()},
        cv.CLIP_TINY)
    assert set(got) == set(want) == set(cv.ClipVision(cv.CLIP_TINY
                                                      ).state_dict())
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_clip_features_at_257_tokens_match_jax(start_image):
    """The port's `encode_image` (the start image in [-1, 1]) against JAX's
    tower on the same preprocessed frame, at 1280 wide and 257 tokens."""
    params, model = _clip_pair(CLIP_1280, seed=5)
    pipe = WanPipeline.__new__(WanPipeline)
    pipe.device, pipe.dtype = torch.device("cpu"), torch.float32
    got = pipe.encode_image(model, start_image).numpy()
    frames = start_image.transpose(2, 0, 1)[None].astype(np.float32)
    pre = jcv.preprocess_frames(jnp.asarray(frames * (2.0 / 255.0) - 1.0),
                                CLIP_1280)
    want = np.asarray(jcv.clip_vision_forward(params, CLIP_1280, pre))
    assert got.shape == want.shape == (1, 257, 1280)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


# ------------------------------------------------------------------ DiT

def test_i2v_dit_forward_matches_jax():
    """The i2v DiT with ``clip_fea`` and ``y``: 1e-4 relative to the
    velocity's scale (fp32)."""
    rng = np.random.default_rng(4)
    dp = jdit.init_wan_dit(jax.random.PRNGKey(7), DCFG)
    dit = WanDiT(TDCFG)
    dit.load_state_dict(convert.dit_from_jax(as_np(dp)))
    z = J_VAE.z_dim
    x = rng.standard_normal((2, z, 3, 8, 8)).astype(np.float32)
    y = rng.standard_normal((2, z + 4, 3, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((2, 16, J_T5.dim)).astype(np.float32)
    fea = rng.standard_normal((2, 257, 1280)).astype(np.float32)
    t = np.array([900.0, 250.0], np.float32)
    cos, sin = jdit.make_rope_for_geometry(DCFG, (3, 4, 4))
    want, _ = jdit.wan_dit_forward_with_residual(
        dp, DCFG, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
        jnp.asarray(cos), jnp.asarray(sin), clip_fea=jnp.asarray(fea),
        y=jnp.asarray(y))
    got = dit(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
              torch.from_numpy(cos), torch.from_numpy(sin),
              clip_fea=torch.from_numpy(fea), y=torch.from_numpy(y))
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_departure_i2v_forward_without_clip_fea():
    """JAX's i2v forward without ``clip_fea`` takes context tokens 0-256 as
    its image stream: it equals the port's forward with the image MLP taken
    away (so its blocks see the text embedding whole and split it at 257).
    The port's i2v DiT raises on that call instead."""
    rng = np.random.default_rng(6)
    dp = jdit.init_wan_dit(jax.random.PRNGKey(8), DCFG)
    dit = WanDiT(TDCFG)
    dit.load_state_dict(convert.dit_from_jax(as_np(dp)))
    z = J_VAE.z_dim
    x = rng.standard_normal((1, z, 2, 8, 8)).astype(np.float32)
    y = rng.standard_normal((1, z + 4, 2, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((1, 512, J_T5.dim)).astype(np.float32)
    t = np.array([500.0], np.float32)
    cos, sin = jdit.make_rope_for_geometry(DCFG, (2, 4, 4))
    args = [torch.from_numpy(a) for a in (x, t, ctx, cos, sin)]
    with pytest.raises(ValueError, match="clip_fea"):
        dit(*args, y=torch.from_numpy(y))
    want, _ = jdit.wan_dit_forward_with_residual(
        dp, DCFG, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
        jnp.asarray(cos), jnp.asarray(sin), y=jnp.asarray(y))
    want = np.asarray(want)
    assert np.isfinite(want).all()      # JAX raises nothing
    del dit.img_emb
    got = dit(*args, y=torch.from_numpy(y)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


# ----------------------------------------------------------- conditioning

@pytest.mark.parametrize("end", [False, True])
def test_get_image_to_video_latent_matches_jax(tmp_path, start_image, end):
    """Bit for bit, from a path and from arrays, resized by PIL (40x48 ->
    32x32), with and without the end image."""
    rng = np.random.default_rng(7)
    big = rng.integers(0, 256, (40, 48, 3)).astype(np.uint8)
    path = str(tmp_path / "start.png")
    Image.fromarray(big).save(path)
    end_img = rng.integers(0, 256, (40, 48, 3)).astype(np.uint8) \
        if end else None
    for start in (path, big, [big, start_image]):
        want = jvio.get_image_to_video_latent(start, end_img, FRAMES, (H, W))
        got = vio.get_image_to_video_latent(start, end_img, FRAMES, (H, W))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert vio.get_image_to_video_latent(None, None, 5, (H, W))[2] is None
    assert vio.size_from_base_resolution(3024, 4032, 640) == \
        jvio.size_from_base_resolution(3024, 4032, 640)


def test_prepare_i2v_conditioning_matches_jax(pipes, start_image):
    """y = [keep mask | VAE mode], 1e-5 (fp32)."""
    jpipe, pipe = pipes
    video01, mask255, _ = jvio.get_image_to_video_latent(
        start_image, start_image[::-1], FRAMES, (H, W))
    want = np.asarray(jpipe.prepare_i2v_conditioning(video01, mask255))
    got = pipe.prepare_i2v_conditioning(video01, mask255).numpy()
    assert got.shape == want.shape == (1, 4 + J_VAE.z_dim, 3, 4, 4)
    np.testing.assert_array_equal(got[:, :4], want[:, :4])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("guidance", [1.0, 3.0])
def test_image_to_video_matches_jax(pipes, start_image, guidance):
    """End to end with the same precomputed ``clip_fea`` and noise (as JAX's
    own i2v tests give it): the latents within 2e-4, the frames within one
    uint8 level. JAX runs its fused trajectory, the port the stepwise
    one."""
    jpipe, pipe = pipes
    rng = np.random.default_rng(8)
    fea = rng.standard_normal((1, 257, 1280)).astype(np.float32)
    noise = rng.standard_normal((1, J_VAE.z_dim, 3, 4, 4)).astype(np.float32)
    kw = dict(end_image=start_image[:, ::-1], num_frames=FRAMES, height=H,
              width=W, num_inference_steps=2, guidance_scale=guidance,
              negative_prompt="blurry", max_sequence_length=16,
              clip_fea=fea, noise=noise, output_latents=True)
    want = jpipe.image_to_video(start_image, PROMPT, **kw)
    timings = {}
    got = pipe.image_to_video(start_image, PROMPT, timings=timings, **kw)
    assert set(timings) == {"text", "clip", "encode+latents", "step0",
                            "step1", "decode"}
    assert got.videos.shape == want.videos.shape == (1, 3, FRAMES, H, W)
    np.testing.assert_allclose(got.latents, want.latents, rtol=2e-4,
                               atol=2e-4)
    assert np.abs(got.videos - want.videos).max() * 255 <= 1.0 + 1e-3
    with pytest.raises(ValueError, match="one prompt"):
        pipe.image_to_video(start_image, ["a", "b"], num_frames=FRAMES,
                            height=H, width=W, num_inference_steps=1)


def test_image_to_video_runs_the_clip_tower(pipes, start_image):
    """With a tower and no ``clip_fea``, `image_to_video` encodes the start
    image (through `encode_image`) and gives what it gives with those
    features precomputed."""
    _, pipe = pipes
    _, model = _clip_pair(CLIP_1280, seed=9)
    kw = dict(num_frames=FRAMES, height=H, width=W, num_inference_steps=1,
              guidance_scale=1.0, max_sequence_length=16, seed=2,
              output_latents=True)
    a = pipe.image_to_video(start_image, PROMPT, clip=model, **kw)
    fea = pipe.encode_image(model, start_image)
    b = pipe.image_to_video(start_image, PROMPT, clip_fea=fea, **kw)
    np.testing.assert_array_equal(a.latents, b.latents)
    with pytest.raises(ValueError, match="clip_fea"):
        pipe.image_to_video(start_image, PROMPT, **kw)


def test_departure_clip_sees_minus_one_to_one(pipes, start_image,
                                              monkeypatch):
    """JAX's `image_to_video` hands `preprocess_frames` (whose contract is
    [-1, 1]) the start image in [0, 1]; the port's hands it [-1, 1]."""
    jpipe, pipe = pipes
    image = start_image.copy()
    image[0, 0], image[0, 1] = 0, 255
    seen = {}

    class Stop(Exception):
        pass

    def spy(name, real):
        def f(frames, cfg):
            arr = np.asarray(frames)
            seen[name] = (float(arr.min()), float(arr.max()))
            raise Stop
        return f

    monkeypatch.setattr(jcv, "preprocess_frames",
                        spy("jax", jcv.preprocess_frames))
    monkeypatch.setattr(cv, "preprocess_frames",
                        spy("port", cv.preprocess_frames))
    params, model = _clip_pair(CLIP_1280, seed=9)
    kw = dict(num_frames=FRAMES, height=H, width=W, num_inference_steps=1,
              guidance_scale=1.0, max_sequence_length=16)
    with pytest.raises(Stop):
        jpipe.image_to_video(image, PROMPT, clip_params=params,
                             clip_cfg=CLIP_1280, **kw)
    with pytest.raises(Stop):
        pipe.image_to_video(image, PROMPT, clip=model, **kw)
    assert seen["jax"] == (0.0, 1.0)
    assert seen["port"] == (-1.0, 1.0)


# ----------------------------------------------------------- checkpoints

def _published_i2v_dit(rng):
    dit = WanDiT(TDCFG)
    dit.load_state_dict({k: torch.from_numpy(rng.standard_normal(
        tuple(v.shape)).astype(np.float32))
        for k, v in dit.state_dict().items()})
    return dit, checkpoint.export_dit_state_dict(dit.state_dict(), TDCFG)


def test_i2v_state_dict_converter_matches_jax():
    """The image branch's published keys (``img_emb.proj.*``, ``k_img``,
    ``v_img``, ``norm_k_img``) through the port's converter, bit for bit
    JAX's converter (then `dit_from_jax`), and back through the port's
    exporter."""
    dit, sd = _published_i2v_dit(np.random.default_rng(10))
    assert "img_emb.proj.4.bias" in sd
    assert "blocks.1.cross_attn.norm_k_img.weight" in sd
    want = convert.dit_from_jax(as_np(jweights.convert_dit_state_dict(
        {k: v.numpy() for k, v in sd.items()}, DCFG)))
    got = weights.convert_dit_state_dict(sd, TDCFG)
    assert set(got) == set(want) == set(dit.state_dict())
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], dit.state_dict()[k]), k


def test_i2v_checkpoint_config_reads_back(tmp_path):
    """An i2v directory's ``config.json`` gives the i2v config (JAX's reads
    ``model_type`` too)."""
    dit, _ = _published_i2v_dit(np.random.default_rng(11))
    checkpoint.save_dit_checkpoint_dir(str(tmp_path), dit, TDCFG)
    assert weights.dit_config_from_checkpoint(str(tmp_path)) == TDCFG
    assert jweights.dit_config_from_checkpoint(str(tmp_path)).model_type \
        == "i2v"


def test_cli_start_image_matches_jax(pipes, tmp_path, monkeypatch):
    """``fast_infer --start_image`` (and ``--end_image``) in both packages,
    on tiny pipelines of the same weights, with the same noise and CLIP
    features given to both (JAX's CLI hands its pipeline no CLIP tower,
    the port's hands it ``pipe.clip``): the item, its size (the image's
    aspect ratio over the flags' area, multiples of 16) and the saved
    video within one uint8 level."""
    import os
    import sys

    import videocof_tpu.cli._common as jcommon
    import videocof_tpu.cli.fast_infer as jcli
    from videocof_torch.cli import _common as common
    from videocof_torch.cli import fast_infer as cli

    jpipe, pipe = pipes
    rng = np.random.default_rng(12)
    paths = []
    for name in ("start.png", "end.png"):
        paths.append(str(tmp_path / name))
        Image.fromarray(rng.integers(0, 256, (40, 80, 3)).astype(
            np.uint8)).save(paths[-1])
    fea = rng.standard_normal((1, 257, 1280)).astype(np.float32)
    noise = rng.standard_normal((1, J_VAE.z_dim, 3, 4, 8)).astype(np.float32)
    _, tower = _clip_pair(CLIP_1280, seed=13)
    monkeypatch.setattr(pipe, "clip", tower)
    saved, calls = {}, {}
    for tag, p, mod, main in (("jax", jpipe, jcommon, jcli),
                              ("port", pipe, common, cli)):
        real = p.image_to_video

        def wrapped(*a, _r=real, _t=tag, **k):
            calls[_t] = k
            k = {n: v for n, v in k.items() if n not in ("clip", "clip_fea")}
            return _r(*a, clip_fea=fea, noise=noise, **k)

        monkeypatch.setattr(p, "image_to_video", wrapped)
        monkeypatch.setattr(mod, "save_results",
                            lambda v, path, fps=16, _t=tag: saved.setdefault(
                                (_t, os.path.basename(path)), np.asarray(v)))
        for m in (mod, main):
            monkeypatch.setattr(m, "build_pipeline_from_args",
                                lambda args, _p=p, **kw: _p)
        monkeypatch.setattr(sys, "argv", [
            "fast_infer", "--start_image", paths[0], "--end_image", paths[1],
            "--prompt", PROMPT, "--output_dir", str(tmp_path / tag),
            "--num_frames", str(FRAMES), "--height", "32", "--width", "64",
            "--random_init", "--num_inference_steps", "2"])
        main.main()
    assert calls["port"]["clip"] is tower and "clip" not in calls["jax"]
    for k in ("height", "width", "num_frames", "end_image"):
        assert calls["port"][k] == calls["jax"][k], k
    assert (calls["port"]["height"], calls["port"]["width"]) == (32, 64)
    got, want = saved[("port", "gen_start.mp4")], saved[("jax",
                                                         "gen_start.mp4")]
    assert got.shape == want.shape == (1, 3, FRAMES, 32, 64)
    assert np.abs(got - want).max() * 255 <= 1.0 + 1e-3
    with open(tmp_path / "port" / "gen_start_info.txt") as f:
        assert f.read() == PROMPT


def test_factory_reads_an_i2v_directory_with_its_clip_file(tmp_path,
                                                           monkeypatch):
    """An i2v directory gives a pipeline holding the CLIP tower written
    beside the DiT (``visual.*`` keys); without the file the factory
    raises, naming it; ``random_init`` with an i2v config draws a tower.
    (The tower's config is the one-block 1280-wide ViT: ViT-H/14's 632M
    weights are too many for a CPU test.)"""
    import os

    from videocof_torch import factory
    from videocof_torch.configs import T5Config, WanVAEConfig

    from _published_layouts import t5_published_name, vae_published_name
    monkeypatch.setattr(factory, "CLIP_VIT_H_14", CLIP_1280)
    tvcfg = convert.config_from(WanVAEConfig, J_VAE)
    tt5cfg = convert.config_from(T5Config, J_T5)
    rng = np.random.default_rng(14)
    fill = lambda m: {k: torch.from_numpy(rng.standard_normal(  # noqa: E731
        tuple(v.shape)).astype(np.float32)) for k, v in m.state_dict().items()}
    dit, _ = _published_i2v_dit(rng)
    root = str(tmp_path)
    checkpoint.save_dit_checkpoint_dir(root, dit, TDCFG)
    torch.save({vae_published_name(k, tvcfg): v
                for k, v in fill(WanVAE(tvcfg)).items()},
               os.path.join(root, factory.VAE_SUBPATH))
    torch.save({t5_published_name(k): v
                for k, v in fill(T5Encoder(tt5cfg)).items()},
               os.path.join(root, factory.T5_SUBPATH))
    kw = dict(dtype=torch.float32, vae_cfg=tvcfg, t5_cfg=tt5cfg,
              require_real_tokenizer=False, device="cpu")
    with pytest.raises(FileNotFoundError, match=cv.CLIP_FILE):
        factory.load_pipeline(root, **kw)
    tower = cv.ClipVision(CLIP_1280)
    tower.load_state_dict(fill(tower))
    torch.save({"model." + k: v for k, v in cv.export_clip_state_dict(
        tower.state_dict(), CLIP_1280).items()},
        os.path.join(root, cv.CLIP_FILE))
    pipe = factory.load_pipeline(root, **kw)
    assert pipe.dit.cfg == TDCFG and isinstance(pipe.clip, cv.ClipVision)
    for k, v in tower.state_dict().items():
        assert torch.equal(pipe.clip.state_dict()[k], v), k
    drawn = factory.load_pipeline("", random_init=True, dit_cfg=TDCFG, **{
        k: v for k, v in kw.items() if k != "require_real_tokenizer"})
    assert drawn.clip.cfg == CLIP_1280 and hasattr(drawn.dit, "img_emb")
