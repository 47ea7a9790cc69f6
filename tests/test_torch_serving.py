"""The port's serving controller (`videocof_torch.serving.controller`)
against the JAX package's (`videocof_tpu.serving.VideoCoFController`) on
tiny pipelines of the same weights: the edit and text-to-video with the
same noise; the LoRA sequence A -> (B, 0.5) -> none on one expert, two
experts and fp8 experts (runtime adapters); the weight swap from a single
checkpoint, a Wan2.2 dual-expert directory, a single one on a MoE pipeline
(fused LoRA unmerged first) and into fp8 experts (re-quantized, adapters
detached); the refusals; the per-request knobs. Then umT5 offload: the
factory, the embeddings and the CLIs' flag. JAX runs its stepwise loop
(``VIDEOCOF_STEPWISE=1``, ``fused_sampling=False``)."""

import dataclasses
import sys

import jax
import numpy as np
import pytest
import torch

import videocof_tpu.cli.fast_infer as jcli
import videocof_tpu.cli.infer as jinfer
from videocof_tpu.configs import GenerationConfig as JGen
from videocof_tpu.models import wan_dit as jdit
from videocof_tpu.serving import VideoCoFController as JController
from videocof_tpu.utils.checkpoint import save_dit_safetensors as jsave
from videocof_torch import factory
from videocof_torch.cli import _common as common
from videocof_torch.cli import fast_infer, infer
from videocof_torch.configs import GenerationConfig
from videocof_torch.models.wan_dit import WanDiT, make_rope_for_geometry
from videocof_torch.pipeline import WanPipeline
from videocof_torch.serving import VideoCoFController
from videocof_torch.serving import api
from videocof_torch.utils import checkpoint

from _serving_pipes import (DCFG, EDIT_NOISE_SHAPE, FRAMES, SIZE, TDCFG,
                            TT5CFG, TVCFG, as_np, assert_dit_matches,
                            assert_fp8_matches, inject, lora_file, pipelines)

torch.set_num_threads(1)

PROMPT = "remove the red ball from the table"
FWD_REL = 1e-2      # bf16 compute over fp8 weights (test_torch_runtime_lora)
MERGE_ATOL = 1e-6   # fp32 merges, both sides (test_torch_lora_merge)


@pytest.fixture(autouse=True)
def _stepwise(monkeypatch):
    monkeypatch.setenv("VIDEOCOF_STEPWISE", "1")
    monkeypatch.setenv("VIDEOCOF_FETCH_YUV420", "0")


def _controllers(jpipe, pipe, **kw):
    return (JController(jpipe, defaults=JGen(**kw)),
            VideoCoFController(pipe, defaults=GenerationConfig(**kw)))


def _edit_defaults():
    return dict(source_frames=FRAMES, reasoning_frames=4,
                num_inference_steps=2, guidance_scale=1.0)


def _assert_outputs_match(got, want):
    np.testing.assert_allclose(got.latents, want.latents, rtol=2e-4,
                               atol=2e-4)
    # frames are quantized to uint8: a latent ulp may flip one level
    assert np.abs(got.videos - want.videos).max() * 255 <= 1.0 + 1e-3


# ------------------------------------------------------------ generation

def test_generate_matches_jax():
    jpipe, pipe = pipelines()
    noise = np.random.default_rng(0).standard_normal(
        EDIT_NOISE_SHAPE).astype(np.float32)
    jout, out = [], []
    inject(jpipe, noise, jout, fused_sampling=False)
    inject(pipe, noise, out)
    jc, c = _controllers(jpipe, pipe, **_edit_defaults())
    video = np.random.default_rng(1).integers(
        0, 256, (1, 3, FRAMES, SIZE, SIZE), dtype=np.uint8)
    want = jc.generate(video_array=video, prompt=PROMPT, seed=3)
    got = c.generate(video_array=video, prompt=PROMPT, seed=3)
    assert got["prompt"] == want["prompt"] and "grounded" in got["prompt"]
    assert got["videos"].shape == want["videos"].shape == (1, 3, 10, SIZE,
                                                           SIZE)
    assert got["edit_videos"].shape == (1, 3, FRAMES, SIZE, SIZE)
    _assert_outputs_match(out[0], jout[0])


def test_generate_t2v_on_moe_matches_jax():
    jpipe, pipe = pipelines(moe=True)
    noise = np.random.default_rng(2).standard_normal(
        (1, TVCFG.z_dim, 3, SIZE // 8, SIZE // 8)).astype(np.float32)
    jout, out = [], []
    inject(jpipe, noise, jout, fused_sampling=False)
    inject(pipe, noise, out)
    jc, c = _controllers(jpipe, pipe, num_inference_steps=4,
                         guidance_scale=3.0)
    kw = dict(prompt="a red kite over a quiet lake", height=SIZE, width=SIZE,
              num_frames=9, seed=3, guidance_scale_2=2.0, shift=5.0)
    want = jc.generate_t2v(**kw)
    got = c.generate_t2v(**kw)
    assert got["ground_videos"] is None and want["ground_videos"] is None
    assert got["videos"].shape == (1, 3, 9, SIZE, SIZE)
    assert 0 < pipe._split_idx(pipe._scheduler("unipc", 4, 5.0, None)) < 4
    _assert_outputs_match(out[0], jout[0])


# ------------------------------------------------------------------ LoRA

def _lora_files(tmp_path):
    return (lora_file(str(tmp_path / "a.safetensors"), 0, "kohya", head=True),
            lora_file(str(tmp_path / "b.safetensors"), 1, "peft", rank=3))


@pytest.mark.parametrize("moe", [False, True], ids=["one_expert", "moe"])
def test_ensure_lora_sequence_merges_like_jax(tmp_path, moe):
    """A -> (B, 0.5) -> none: every expert's weights follow JAX's trees
    within fp32 rounding after each request's LoRA set."""
    a, b = _lora_files(tmp_path)
    jpipe, pipe = pipelines(moe=moe)
    jc, c = JController(jpipe), VideoCoFController(pipe)
    experts = [("dit_params", "dit")] + (
        [("dit_params_2", "dit_2")] if moe else [])
    before = {attr: as_np(getattr(jpipe, jattr)) for jattr, attr in experts}
    for path, mult in ((a, 1.0), (b, 0.5), (None, 1.0)):
        jc.ensure_lora(path, mult)
        c.ensure_lora(path, mult)
        assert c._merged_loras == jc._merged_loras
        for jattr, attr in experts:
            assert_dit_matches(getattr(pipe, attr), getattr(jpipe, jattr),
                               atol=MERGE_ATOL)
    for jattr, attr in experts:      # unmerged back to the originals
        assert_dit_matches(getattr(pipe, attr), before[attr],
                           atol=MERGE_ATOL)


def test_ensure_lora_over_fp8_attaches_jax_adapters(tmp_path):
    a, b = _lora_files(tmp_path)
    jpipe, pipe = pipelines(fp8=True)
    jc, c = JController(jpipe), VideoCoFController(pipe)
    assert c._params_quantized() and jc._params_quantized()
    rng = np.random.default_rng(4)
    grid = (3, 2, 2)
    x = rng.standard_normal((1, DCFG.in_dim, grid[0], 4, 4)).astype(
        np.float32)
    ctx = rng.standard_normal((1, DCFG.text_len, DCFG.text_dim)).astype(
        np.float32)
    cos, sin = make_rope_for_geometry(TDCFG, grid)
    for path, mult in ((a, 1.0), (b, 0.5)):
        jc.ensure_lora(path, mult)
        c.ensure_lora(path, mult)
        assert c._merged_loras == jc._merged_loras == {path: mult}
        node = jpipe.dit_params["lora__"]
        adapters, scale = pipe.dit.runtime_lora
        assert scale == float(node["scale"]) == 1.0
        for mod, names in node["blocks"].items():
            for name, ad in names.items():
                for i in range(TDCFG.num_layers):
                    lin = adapters.blocks[i][mod][name]
                    np.testing.assert_array_equal(
                        lin.down.detach().numpy(), np.asarray(ad["down"][i]))
                    np.testing.assert_array_equal(
                        lin.up.detach().numpy(), np.asarray(ad["up"][i]))
        t = np.array([500.0], np.float32)
        want = np.asarray(jdit.wan_dit_forward(
            jpipe.dit_params, DCFG, *(jax.numpy.asarray(v) for v in (
                x, t, ctx, cos, sin))))
        with torch.no_grad():
            got = pipe.dit(*(torch.as_tensor(v) for v in (
                x, t, ctx, cos, sin))).numpy()
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert np.isfinite(got).all() and rel <= FWD_REL, rel
    jc.ensure_lora(None)
    c.ensure_lora(None)
    assert "lora__" not in jpipe.dit_params and pipe.dit.runtime_lora is None
    assert c._merged_loras == {} and all(
        b.ffn.fc1.weight.dtype == torch.float8_e4m3fn for b in pipe.dit.blocks)


def test_ensure_lora_refuses_a_pipeline_that_is_not_wan():
    class Other:
        cfg_sequential = False
    with pytest.raises(TypeError, match="Wan"):
        VideoCoFController(Other()).ensure_lora("x.safetensors")
    with pytest.raises(TypeError, match="Wan"):
        VideoCoFController(Other()).update_diffusion_transformer("ckpt")


# ----------------------------------------------------------- weight swap

def _scaled_file(path, jparams, scale):
    """JAX's writer: ``scale`` x the JAX tree, as one safetensors file."""
    jsave(str(path), jax.tree.map(lambda a: a * scale, as_np(jparams)), DCFG)
    return str(path)


def test_swap_single_expert_matches_jax(tmp_path):
    jpipe, pipe = pipelines()
    ckpt = _scaled_file(tmp_path / "dit_v2.safetensors", jpipe.dit_params,
                        2.0)
    jc, c = JController(jpipe), VideoCoFController(pipe)
    c._merged_loras["stale"] = 1.0
    ids = {k: v.data_ptr() for k, v in pipe.dit.state_dict().items()}
    jc.update_diffusion_transformer(ckpt)
    c.update_diffusion_transformer(ckpt)
    assert_dit_matches(pipe.dit, jpipe.dit_params)
    assert c._merged_loras == {}
    # in place: the resident tensors were overwritten, not replaced
    assert {k: v.data_ptr() for k, v in pipe.dit.state_dict().items()} == ids
    c.update_diffusion_transformer("none")          # a no-op
    assert_dit_matches(pipe.dit, jpipe.dit_params)


def test_swap_dual_expert_directory_matches_jax(tmp_path):
    jpipe, pipe = pipelines(moe=True)
    root = tmp_path / "wan22"
    for sub, tree, s in (("low_noise_model", jpipe.dit_params, 2.0),
                         ("high_noise_model", jpipe.dit_params_2, 3.0)):
        (root / sub).mkdir(parents=True)
        _scaled_file(root / sub / "model.safetensors", tree, s)
    jc, c = JController(jpipe), VideoCoFController(pipe)
    jc.update_diffusion_transformer(str(root))
    c.update_diffusion_transformer(str(root))
    assert_dit_matches(pipe.dit, jpipe.dit_params)
    assert_dit_matches(pipe.dit_2, jpipe.dit_params_2)
    # a dual-expert directory on a one-expert pipeline is refused
    _, single = pipelines()
    with pytest.raises(RuntimeError, match="high-noise"):
        VideoCoFController(single).update_diffusion_transformer(str(root))


def test_single_expert_swap_on_moe_unmerges_lora_first(tmp_path):
    a, _ = _lora_files(tmp_path)
    jpipe, pipe = pipelines(moe=True)
    orig2 = as_np(jpipe.dit_params_2)
    ckpt = _scaled_file(tmp_path / "single.safetensors", jpipe.dit_params,
                        2.0)
    jc, c = JController(jpipe), VideoCoFController(pipe)
    jc.ensure_lora(a)
    c.ensure_lora(a)
    jc.update_diffusion_transformer(ckpt)
    c.update_diffusion_transformer(ckpt)
    assert_dit_matches(pipe.dit, jpipe.dit_params)
    assert_dit_matches(pipe.dit_2, jpipe.dit_params_2, atol=MERGE_ATOL)
    assert_dit_matches(pipe.dit_2, orig2, atol=MERGE_ATOL)   # pristine
    assert c._merged_loras == jc._merged_loras == {}


def test_swap_into_fp8_requantizes_and_detaches_adapters(tmp_path):
    a, _ = _lora_files(tmp_path)
    jpipe, pipe = pipelines(fp8=True)
    draw = jdit.init_wan_dit(jax.random.PRNGKey(7), DCFG)
    ckpt = _scaled_file(tmp_path / "other.safetensors", draw, 1.0)
    jc, c = JController(jpipe), VideoCoFController(pipe)
    jc.ensure_lora(a)
    c.ensure_lora(a)
    assert pipe.dit.runtime_lora is not None
    jc.update_diffusion_transformer(ckpt)
    c.update_diffusion_transformer(ckpt)
    # JAX's tree replacement leaves no adapters; the port detaches them
    assert "lora__" not in jpipe.dit_params
    assert pipe.dit.runtime_lora is None and c._merged_loras == {}
    assert_fp8_matches(pipe.dit, as_np(jpipe.dit_params))


def test_wrong_checkpoint_raises_and_leaves_the_weights(tmp_path):
    jpipe, pipe = pipelines()
    c = VideoCoFController(pipe)
    before = {k: v.clone() for k, v in pipe.dit.state_dict().items()}
    wide = WanDiT(dataclasses.replace(TDCFG, ffn_dim=2 * TDCFG.ffn_dim))
    ckpt = str(tmp_path / "wide.safetensors")
    checkpoint.save_dit_safetensors(ckpt, wide, wide.cfg)
    with pytest.raises(ValueError, match="architecture"):
        c.update_diffusion_transformer(ckpt)
    for k, v in pipe.dit.state_dict().items():
        assert torch.equal(v, before[k]), k
    # a checkpoint of another family: both controllers switch to its
    # pipeline (`test_torch_family_serving.py` holds what it generates)
    from _family_models import flux as tiny_flux
    flux = checkpoint.save_family_checkpoint_dir(str(tmp_path / "flux"),
                                                 tiny_flux(True)[1])
    from videocof_tpu.factory import detect_family as jdetect
    assert factory.detect_family(flux) == jdetect(flux) == "flux"
    assert factory.detect_family(str(tmp_path)) == "wan"
    jc = JController(jpipe)
    jc.update_diffusion_transformer(flux)
    c.update_diffusion_transformer(flux)
    assert c.family == jc.family == "flux"
    assert type(c.pipeline).__name__ == type(jc.pipeline).__name__


# --------------------------------------------------------- request knobs

class _FakeOut:
    videos = np.zeros((1, 3, 1, 8, 8), np.float32)
    ground_videos = None
    edit_videos = videos


class _FakePipe:
    """Keeps each call's cfg_sequential and keyword arguments."""

    def __init__(self, cfg_sequential=False):
        self.cfg_sequential = cfg_sequential
        self.seen = []

    def __call__(self, video, prompt, **kw):
        self.seen.append((self.cfg_sequential, kw))
        return _FakeOut()

    def text_to_video(self, prompt, **kw):
        self.seen.append((self.cfg_sequential, kw))
        return _FakeOut()


@pytest.mark.parametrize("default", [False, True])
def test_cfg_sequential_resets_per_request(default):
    video = np.zeros((1, 3, FRAMES, 8, 8), np.uint8)
    sides = []
    for ctrl_cls in (JController, VideoCoFController):
        pipe = _FakePipe(default)
        c = ctrl_cls(pipe)
        c.generate(video_array=video, prompt="x", cfg_sequential=not default)
        c.generate(video_array=video, prompt="x")
        c.generate_t2v("x", cfg_sequential=not default)
        c.generate_t2v("x")
        sides.append([s for s, _ in pipe.seen])
    assert sides[0] == sides[1] == [not default, default] * 2


def test_teacache_alias_resolves_like_jax():
    sides = []
    for ctrl_cls in (JController, VideoCoFController):
        pipe = _FakePipe()
        c = ctrl_cls(pipe, model_name="Wan2.1-T2V-1.3B")
        c.generate_t2v("a fox", enable_teacache=True)
        c.generate(video_array=np.zeros((1, 3, 9, 8, 8), np.uint8),
                   prompt="x", enable_teacache=True)
        sides.append([kw["teacache_coefficients"] for _, kw in pipe.seen])
    assert sides[0] == sides[1] and sides[0][0] is not None


def test_generate_media_on_wan_raises():
    _, pipe = pipelines()
    c = VideoCoFController(pipe)
    assert c.family == "wan"
    with pytest.raises(RuntimeError, match="Wan"):
        c.generate_media(np.zeros((1, 4, 8), np.float32))


def test_encoders_match_jax():
    pytest.importorskip("cv2")
    video = np.random.default_rng(5).uniform(0, 1, (1, 3, 4, 16, 16))
    b64 = VideoCoFController.encode_video_base64(video)
    assert len(b64) > 100
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    assert (VideoCoFController.encode_array_base64(arr)
            == JController.encode_array_base64(arr))
    pytest.importorskip("PIL")
    img = np.random.default_rng(6).uniform(0, 1, (3, 8, 8))
    assert (VideoCoFController.encode_image_base64(img)
            == JController.encode_image_base64(img))


# ---------------------------------------------------------- umT5 offload

def test_factory_offload_keeps_umt5_on_the_host():
    pipe = factory.load_pipeline("", dtype=torch.float32, random_init=True,
                                 dit_cfg=TDCFG, vae_cfg=TVCFG, t5_cfg=TT5CFG,
                                 seed=5, offload_t5=True, device="cpu")
    assert pipe.offload_t5
    assert all(p.device.type == "cpu" for p in pipe.t5.parameters())
    resident = factory.load_pipeline("", dtype=torch.float32,
                                     random_init=True, dit_cfg=TDCFG,
                                     vae_cfg=TVCFG, t5_cfg=TT5CFG, seed=5,
                                     device="cpu")
    assert not resident.offload_t5
    for k, v in resident.t5.state_dict().items():      # the same draw
        assert torch.equal(pipe.t5.state_dict()[k], v), k


def test_offloaded_encoder_gives_the_resident_embeddings(monkeypatch):
    _, pipe = pipelines()
    off = WanPipeline(pipe.dit, pipe.vae, pipe.t5, dtype=torch.float32,
                      device="cpu", offload_t5=True)
    calls = []
    real = torch.func.functional_call

    def spy(module, state, args, *a, **kw):
        calls.append(sorted(state))
        return real(module, state, args, *a, **kw)
    monkeypatch.setattr(torch.func, "functional_call", spy)
    prompts = [PROMPT, "a red kite over a quiet lake"]
    got = off.encode_prompt(prompts, max_length=16)
    assert calls == [sorted(pipe.t5.state_dict())]    # the transient copy
    monkeypatch.setattr(torch.func, "functional_call", real)
    resident = WanPipeline(pipe.dit, pipe.vae, pipe.t5, dtype=torch.float32,
                           device="cpu")
    assert torch.equal(got, resident.encode_prompt(prompts, max_length=16))
    ids, mask = (torch.as_tensor(a) for a in resident.tokenizer(
        prompts, max_length=16))
    direct = pipe.t5(ids, mask)         # the module's own forward
    assert torch.equal(got, direct * mask[..., None].to(direct.dtype))


@pytest.mark.parametrize("entry", ["fast_infer", "infer", "serving.api"])
def test_offload_t5_reaches_the_factory(tmp_path, monkeypatch, entry):
    seen = {}

    def load(model_name, **kw):
        seen.update(kw)
        raise RuntimeError("stop after the factory's arguments")
    monkeypatch.setattr(factory, "load_pipeline", load)
    if entry == "serving.api":
        with pytest.raises(RuntimeError, match="stop"):
            api.main(["--random_init", "--offload_t5", "--quantize", "fp8"])
        assert seen["quantize"] == "fp8"
    else:
        port_cli, jax_cli = {"fast_infer": (fast_infer, jcli),
                             "infer": (infer, jinfer)}[entry]
        argv = ["--video_path", "v.mp4", "--prompt", "x", "--output_dir",
                str(tmp_path), "--random_init", "--offload_t5"]
        monkeypatch.setattr(sys, "argv", [entry] + argv)
        assert vars(port_cli.parse_args(argv)) == vars(jax_cli.parse_args())
        with pytest.raises(RuntimeError, match="stop"):
            common.build_pipeline_from_args(port_cli.parse_args(argv))
    assert seen["offload_t5"] is True and seen["random_init"]
