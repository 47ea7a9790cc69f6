"""The port's `fast_infer` and `infer` entries against the JAX package's:
each pair of CLIs on the same synthetic ``mp4v`` clip with tiny pipelines of
the same weights and the same noise (outputs captured before encoding,
latents within 2e-4, frames within one uint8 level, the same files; for
`fast_infer` a resume that writes nothing; `infer` with its defaults,
TeaCache on and CFG 5, and its flags), the
CoT prompt of the reference's four task kinds, frame loading (uint8,
float32, I420), the I420 input of the pipeline, and the factory on random
weights and on a tiny checkpoint directory.

JAX's frame loading is held on its cv2 path (its native libav runtime is
not ported): ``videocof_tpu.runtime._load`` is made to find no library."""

import json
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
import videocof_tpu.runtime as jruntime
from videocof_tpu.configs import T5_TINY as J_T5, VAE_TINY as J_VAE
from videocof_tpu.configs import WAN_TINY as J_WAN
from videocof_tpu.data import instructions as jinstructions
from videocof_tpu.models import t5_encoder as jt5, wan_dit as jdit
from videocof_tpu.models import wan_vae as jvae, weights as jweights
from videocof_tpu.pipeline import WanPipeline as JaxPipeline
from videocof_tpu.utils import video_io as jvideo_io
from videocof_torch import convert, factory
from videocof_torch.cli import _common as common
from videocof_torch.cli import fast_infer as cli
from videocof_torch.cli import infer
from videocof_torch.configs import T5Config, WanDiTConfig, WanVAEConfig
from videocof_torch.data import instructions
from videocof_torch.models import lora
from videocof_torch.models.teacache import get_teacache_coefficients
from videocof_torch.models.t5_encoder import T5Encoder
from videocof_torch.models.wan_dit import WanDiT, init_wan_dit
from videocof_torch.models.wan_vae import WanVAE
from videocof_torch.pipeline import WanPipeline, latent_frame_count
from videocof_torch.utils import checkpoint, colorspace, video_io

from _published_layouts import t5_published_name, vae_published_name

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DCFG = J_WAN.replace(in_dim=J_VAE.z_dim, out_dim=J_VAE.z_dim,
                     text_dim=J_T5.dim)
TDCFG = convert.config_from(WanDiTConfig, DCFG)
TVCFG = convert.config_from(WanVAEConfig, J_VAE)
TT5CFG = convert.config_from(T5Config, J_T5)
FRAMES, SIZE = 9, 32


@pytest.fixture(autouse=True)
def _jax_cv2_path(monkeypatch):
    """JAX's video I/O on its cv2 path, stepwise sampling, RGB readback."""
    monkeypatch.setattr(jruntime, "_load", lambda: None)
    monkeypatch.setenv("VIDEOCOF_STEPWISE", "1")
    monkeypatch.setenv("VIDEOCOF_FETCH_YUV420", "0")
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 12-frame 32x32 mp4v clip drawn from a numpy seed."""
    path = str(tmp_path_factory.mktemp("vid") / "in.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10,
                        (SIZE, SIZE))
    rng = np.random.default_rng(0)
    for _ in range(12):
        w.write(rng.integers(0, 255, (SIZE, SIZE, 3), dtype=np.uint8))
    w.release()
    return path


@pytest.fixture(scope="module")
def pipelines():
    as_np = lambda p: jax.tree.map(np.asarray, p)  # noqa: E731
    dp = jdit.init_wan_dit(jax.random.PRNGKey(0), DCFG)
    vp = jvae.init_wan_vae(jax.random.PRNGKey(1), J_VAE)
    tp = jt5.init_t5_encoder(jax.random.PRNGKey(2), J_T5)
    jpipe = JaxPipeline(dp, DCFG, vp, J_VAE, tp, J_T5, dtype=jnp.float32)
    dit = WanDiT(TDCFG)
    dit.load_state_dict(convert.dit_from_jax(as_np(dp)))
    vae = WanVAE(TVCFG)
    vae.load_state_dict(convert.vae_from_jax(as_np(vp)))
    t5 = T5Encoder(TT5CFG)
    t5.load_state_dict(convert.t5_from_jax(as_np(tp)))
    return jpipe, WanPipeline(dit, vae, t5, dtype=torch.float32, device="cpu")


class _Capturing:
    """A pipeline whose calls get the same ``noise`` (and ``extra``
    arguments) and keep their outputs."""

    def __init__(self, pipe, noise, **extra):
        self.pipe, self.noise, self.extra = pipe, noise, extra
        self.videos, self.outputs, self.kwargs = [], [], []

    def __call__(self, *args, **kw):
        self.videos.append(args[0])
        self.kwargs.append(kw)
        out = self.pipe(*args, noise=self.noise, output_latents=True,
                        **self.extra, **kw)
        self.outputs.append(out)
        return out


def _drive(module, cli_module, pipe, out_dir, clip, monkeypatch,
           steps=("--num_inference_steps", "2")):
    """Run ``cli_module.main()`` with ``pipe`` (``steps``: the step flags;
    none for the CLI's default); returns {file: the array saved} (captured
    before encoding)."""
    saved = {}
    real = module.save_results

    def save_results(video, path, fps=16):
        saved[os.path.basename(path)] = np.asarray(video)
        real(video, path, fps)

    monkeypatch.setattr(module, "save_results", save_results)
    for m in (module, cli_module):
        monkeypatch.setattr(m, "build_pipeline_from_args",
                            lambda args, **kw: pipe)
    monkeypatch.setattr(sys, "argv", [
        "fast_infer", "--video_path", clip, "--prompt",
        "remove the red ball from the table", "--output_dir", out_dir,
        "--source_frames", str(FRAMES), "--reasoning_frames", "4",
        "--repeat_rope", "--random_init", *steps, "--seed", "3"])
    cli_module.main()
    return saved


@pytest.mark.parametrize("upload", ["uint8", "i420"])
def test_fast_infer_matches_jax(pipelines, clip, tmp_path, monkeypatch,
                                upload):
    monkeypatch.setenv("VIDEOCOF_UPLOAD_YUV420",
                       "1" if upload == "i420" else "0")
    jpipe, pipe = pipelines
    cond = latent_frame_count(FRAMES)
    noise = np.random.default_rng(1).standard_normal(
        (1, J_VAE.z_dim, cond + 1, 4, 4)).astype(np.float32)
    jcap = _Capturing(jpipe, noise, fused_sampling=False)
    cap = _Capturing(pipe, noise)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = _drive(jcommon, jcli, jcap, jdir, clip, monkeypatch)
    got = _drive(common, cli, cap, tdir, clip, monkeypatch)

    ndim = 4 if upload == "i420" else 5
    assert cap.videos[0].ndim == jcap.videos[0].ndim == ndim
    np.testing.assert_array_equal(cap.videos[0], jcap.videos[0])
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == [
        "gen_in.mp4", "gen_in_compare.mp4", "gen_in_info.txt",
        "gen_in_reason_edit.mp4"]
    for name in ("gen_in_info.txt",):
        with open(os.path.join(tdir, name)) as a, \
                open(os.path.join(jdir, name)) as b:
            assert a.read() == b.read()
    np.testing.assert_allclose(cap.outputs[0].latents,
                               jcap.outputs[0].latents, rtol=2e-4, atol=2e-4)
    assert set(got) == set(want) == {"gen_in.mp4", "gen_in_reason_edit.mp4"}
    for name in want:
        assert got[name].shape == want[name].shape
        # frames are quantized to uint8: a latent ulp may flip one level
        assert np.abs(got[name] - want[name]).max() * 255 <= 1.0 + 1e-3
    # resume: a second run finds every output and writes nothing
    stamps = {f: os.stat(os.path.join(tdir, f)).st_mtime_ns
              for f in os.listdir(tdir)}
    assert cli.main() == {}
    assert len(cap.outputs) == 1
    assert stamps == {f: os.stat(os.path.join(tdir, f)).st_mtime_ns
                      for f in os.listdir(tdir)}


def test_infer_matches_jax(pipelines, clip, tmp_path, monkeypatch):
    """The standard CLI with its defaults: 50 steps, CFG 5 against the
    default negative prompt, TeaCache on with Wan2.1 T2V 14B's
    coefficients."""
    jpipe, pipe = pipelines
    cond = latent_frame_count(FRAMES)
    noise = np.random.default_rng(4).standard_normal(
        (1, J_VAE.z_dim, cond + 1, 4, 4)).astype(np.float32)
    jcap = _Capturing(jpipe, noise, fused_sampling=False)
    cap = _Capturing(pipe, noise)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = _drive(jcommon, jinfer, jcap, jdir, clip, monkeypatch, steps=())
    got = _drive(common, infer, cap, tdir, clip, monkeypatch, steps=())

    kw = cap.kwargs[0]
    assert kw["num_inference_steps"] == 50 and kw["guidance_scale"] == 5.0
    assert kw["negative_prompt"] == jinfer.NEGATIVE_PROMPT
    assert kw["enable_teacache"] and kw["teacache_skip_start_steps"] == 5
    assert kw["teacache_coefficients"] == get_teacache_coefficients(
        "wan2.1-t2v-14b")
    for key in ("num_inference_steps", "guidance_scale", "negative_prompt",
                "enable_teacache", "teacache_threshold",
                "teacache_skip_start_steps", "teacache_coefficients"):
        assert np.all(np.asarray(kw[key]) == np.asarray(jcap.kwargs[0][key]))
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    np.testing.assert_allclose(cap.outputs[0].latents,
                               jcap.outputs[0].latents, rtol=2e-4, atol=2e-4)
    assert set(got) == set(want) == {"gen_in.mp4", "gen_in_reason_edit.mp4"}
    for name in want:
        assert got[name].shape == want[name].shape
        assert np.abs(got[name] - want[name]).max() * 255 <= 1.0 + 1e-3


def test_infer_flags_match_jax(tmp_path, monkeypatch):
    argv = ["--prompt", "x", "--video_path", "v.mp4", "--output_dir",
            str(tmp_path), "--disable_teacache", "--cfg_skip_ratio", "0.2",
            "--teacache_threshold", "0.2", "--num_skip_start_steps", "3"]
    monkeypatch.setattr(sys, "argv", ["infer"] + argv)
    want = vars(jinfer.parse_args())
    got = vars(infer.parse_args(argv))
    assert got == want
    assert infer.generation_kwargs(infer.parse_args(argv)) == {
        "cfg_skip_ratio": 0.2}
    # --quantize fp8 passes the port's check and parses as JAX's does
    monkeypatch.setattr(sys, "argv", ["infer"] + argv + ["--quantize", "fp8"])
    args = infer.parse_args(argv + ["--quantize", "fp8"])
    common.check_ported(args)
    assert args.quantize == jinfer.parse_args().quantize == "fp8"


def test_cot_prompt_matches_jax_on_the_reference_tasks():
    with open(os.path.join(ROOT, "assets", "teaser_test.json")) as f:
        items = json.load(f)
    kinds = {item["task_type"] for item in items}
    assert len(kinds) == 4, kinds
    for item in items:
        text = item["edit_instruction"]
        assert (instructions.build_cot_prompt(text)
                == jinstructions.build_cot_prompt(text))
        assert common.item_prompt(item) == jcommon.item_prompt(item)
    for text in ("", "swap the cat with a dog.", "Make the sky purple",
                 "insert a lamp"):
        assert (instructions.derive_ground_object_from_instruction(text)
                == jinstructions.derive_ground_object_from_instruction(text))


@pytest.mark.parametrize("dtype", ["uint8", "float32", "i420"])
@pytest.mark.parametrize("frames", [4, 9, 20])
def test_load_video_frames_matches_jax(clip, dtype, frames):
    got, h, w = video_io.load_video_frames(
        clip, frames, rng=np.random.default_rng(7), dtype=dtype)
    want, jh, jw = jvideo_io.load_video_frames(
        clip, frames, rng=np.random.default_rng(7), dtype=dtype)
    assert (h, w) == (jh, jw) == (SIZE, SIZE)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_load_video_frames_names_what_is_missing(clip, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="cv2"):
        video_io.load_video_frames(clip, 4)


def test_i420_input_matches_jax(pipelines):
    jpipe, pipe = pipelines
    rgb = np.random.default_rng(2).integers(0, 256, (2, 3, 3, 16, 24),
                                            dtype=np.uint8)
    i420 = colorspace.rgb_to_i420(rgb)
    from videocof_tpu.utils import colorspace as jcolorspace
    np.testing.assert_array_equal(i420, np.asarray(jcolorspace.rgb_to_i420(
        jnp.asarray(rgb))))
    want = np.asarray(jpipe._prepare_video(i420, ["a", "b"]))
    got = pipe._prepare_video(i420).numpy()
    assert got.shape == want.shape == (2, 3, 3, 16, 24)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(colorspace.i420_to_rgb01(i420),
                                  jcolorspace.i420_to_rgb01(i420))


def _lora_file(path, seed, fmt):
    """A rank-4 LoRA over every block module of the tiny DiT."""
    rng = np.random.default_rng(seed)
    d, f = TDCFG.dim, TDCFG.ffn_dim
    dims = {"self_attn": (d, d), "cross_attn": (d, d)}
    sd = {}
    for i in range(TDCFG.num_layers):
        for name, (din, dout) in [(f"{a}.{n}", dims[a]) for a in dims
                                  for n in "qkvo"] + [("ffn.0", (d, f)),
                                                      ("ffn.2", (f, d))]:
            down = 0.1 * rng.standard_normal((4, din))
            up = 0.1 * rng.standard_normal((dout, 4))
            if fmt == "kohya":
                base = "lora_unet_" + f"blocks.{i}.{name}".replace(".", "_")
                sd[base + ".lora_down.weight"] = down
                sd[base + ".lora_up.weight"] = up
                sd[base + ".alpha"] = np.array(2.0)
            else:
                sd[f"blocks.{i}.{name}.lora_A.weight"] = down
                sd[f"blocks.{i}.{name}.lora_B.weight"] = up
    checkpoint.write_safetensors(path, {
        k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()})
    return path


def test_factory_random_init_draws_from_the_seed_and_merges(tmp_path):
    loras = [(_lora_file(str(tmp_path / "a.safetensors"), 0, "kohya"), 1.0),
             (_lora_file(str(tmp_path / "b.safetensors"), 1, "peft"), 0.5)]
    pipe = factory.load_pipeline("", dtype=torch.float32, random_init=True,
                                 dit_cfg=TDCFG, vae_cfg=TVCFG, t5_cfg=TT5CFG,
                                 seed=5, lora_paths=loras, device="cpu")
    want = init_wan_dit(TDCFG, torch.Generator().manual_seed(5))
    for path, mult in loras:
        lora.merge_lora(want, path, multiplier=mult)
    for k, v in want.state_dict().items():
        assert torch.equal(pipe.dit.state_dict()[k], v), k
    assert pipe.device.type == "cpu" and pipe.tokenizer.is_fallback
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            factory.load_pipeline("", random_init=True, dit_cfg=TDCFG,
                                  vae_cfg=TVCFG, t5_cfg=TT5CFG)


@pytest.mark.parametrize("kw", [dict(offload_t5=True), dict(precompile={})])
def test_factory_unported_options_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        factory.load_pipeline("", random_init=True, device="cpu", **kw)


@pytest.mark.parametrize("argv", [["--start_image", "a.png"],
                                  ["--control_video", "c.mp4"],
                                  ["--offload_t5"],
                                  ["--precompile_hw", "480", "832"],
                                  ["--attention", "xla"]])
def test_cli_unported_modes_stop(tmp_path, argv):
    with pytest.raises(SystemExit, match="--"):
        cli.main(["--prompt", "x", "--video_path", "v.mp4", "--output_dir",
                  str(tmp_path)] + argv)


def _checkpoint_dir(root):
    """A tiny Wan2.1 checkpoint directory in the published layout: the
    DiT's config and two shards, the VAE and umT5 ``.pth`` files."""
    rng = np.random.default_rng(9)
    fill = lambda sd: {k: torch.from_numpy(  # noqa: E731
        rng.standard_normal(tuple(v.shape)).astype(np.float32))
        for k, v in sd.items()}
    dit = WanDiT(TDCFG)
    dit.load_state_dict(fill(dit.state_dict()))
    checkpoint.save_dit_checkpoint_dir(root, dit, TDCFG, num_shards=2)
    torch.save({vae_published_name(k, TVCFG): v for k, v in
                fill(WanVAE(TVCFG).state_dict()).items()},
               os.path.join(root, factory.VAE_SUBPATH))
    torch.save({t5_published_name(k): v for k, v in
                fill(T5Encoder(TT5CFG).state_dict()).items()},
               os.path.join(root, factory.T5_SUBPATH))
    return dit


def test_factory_reads_a_checkpoint_directory(tmp_path):
    root = str(tmp_path / "ckpt")
    dit = _checkpoint_dir(root)
    lora_path = _lora_file(str(tmp_path / "l.safetensors"), 2, "kohya")
    pipe = factory.load_pipeline(root, dtype=torch.float32, vae_cfg=TVCFG,
                                 t5_cfg=TT5CFG, require_real_tokenizer=False,
                                 lora_paths=[(lora_path, 0.8)], device="cpu")
    assert pipe.dit.cfg == TDCFG
    # JAX's loaders and converters on the same files
    jd = convert.dit_from_jax(jax.tree.map(np.asarray, jweights.convert_dit_state_dict(
        jweights.load_state_dict(root), DCFG)))
    jv = convert.vae_from_jax(jax.tree.map(np.asarray, jweights.convert_vae_state_dict(
        jweights.load_state_dict(os.path.join(root, factory.VAE_SUBPATH)),
        J_VAE)))
    jt = convert.t5_from_jax(jax.tree.map(np.asarray, jweights.convert_t5_state_dict(
        jweights.load_state_dict(os.path.join(root, factory.T5_SUBPATH)),
        J_T5)))
    lora.merge_lora(dit, lora_path, multiplier=0.8)
    for module, want in ((pipe.dit, jd), (pipe.vae, jv), (pipe.t5, jt)):
        for k, v in module.state_dict().items():
            assert torch.equal(v, want[k] if module is not pipe.dit
                               else dit.state_dict()[k]), k
    for k, v in jd.items():
        if not k.startswith("blocks."):
            assert torch.equal(pipe.dit.state_dict()[k], v), k
    with pytest.raises(RuntimeError, match="tokenizer"):
        factory.load_pipeline(root, dtype=torch.float32, vae_cfg=TVCFG,
                              t5_cfg=TT5CFG, device="cpu")


def test_items_and_resume_sharding_match_jax(tmp_path, monkeypatch):
    """Task-JSON items, the finished-output skip and the rank striding
    (``RANK``/``WORLD_SIZE`` without torch.distributed)."""
    args = cli.parse_args(["--test_json", os.path.join(
        ROOT, "assets", "teaser_test.json"), "--output_dir", str(tmp_path)])
    items = common.collect_items(args)
    assert items == jcommon.collect_items(args)
    (tmp_path / f"gen_{os.path.splitext(items[2][0])[0]}.mp4").touch()
    want, _, _ = jcommon.shard_pending(items, str(tmp_path))
    assert common.shard_pending(items, str(tmp_path)) == (want, 0, 1)
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "3")
    assert common.shard_pending(items, str(tmp_path)) == (want[1::3], 1, 3)
