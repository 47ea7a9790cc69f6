"""The controller's family switch and the embeddings-in HTTP request of the
port against the JAX package's, on tiny CPU pipelines: a Wan controller
switched by `update_diffusion_transformer` to a CogVideoX, Flux or
QwenImage directory (the port's `save_family_checkpoint_dir`) and back to a
Wan directory (`save_wan_checkpoint_dir`), in both packages; each family's
`generate_media` on the same embeddings and starting latents (the port's
through ``latents=``, the one keyword beyond JAX's signature), within 2e-4,
the pipelines' tolerance; the fp8 intent carried across a switch as JAX
carries it; and the HTTP request with base64 .npy fields or an allowlisted
``embeddings_path`` .npz, its reply fields (an mp4, a png or .npy latents),
the 400 without embeddings and the 403 outside the allowlist, with the JAX
handler on the same request sequence giving the same codes and fields."""

import base64
import contextlib
import functools
import io
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videocof_tpu.configs import T5_TINY as J_T5, VAE_TINY as J_VAE
from videocof_tpu.pipeline import WanPipeline as JaxWan
from videocof_tpu.serving import VideoCoFController as JController
from videocof_tpu.serving import api as japi
from videocof_torch import convert
from videocof_torch.models.t5_encoder import T5Encoder
from videocof_torch.models.wan_vae import WanVAE
from videocof_torch.pipeline import WanPipeline
from videocof_torch.serving import VideoCoFController, api
from videocof_torch.utils import checkpoint
from videocof_torch.utils.fp8 import is_fp8, quantize_dit_fp8

from _family_models import (J_FLUX, J_QWEN, cogvideox, cogvideox_vae, flux,
                            jax_latents, kl, qwenimage, text)
from _serving_pipes import DCFG, TT5CFG, TVCFG, pipelines, port_dit

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
FAMILIES = ("cogvideox", "flux", "qwenimage")
# each family's request: its embeddings, geometry and JAX's start latents
REQUEST = {
    "cogvideox": dict(text_embeddings=text(0, 1, 8, 32),
                      negative_embeddings=text(1, 1, 8, 32), height=32,
                      width=48, num_frames=9),
    "flux": dict(text_embeddings=text(4, 1, 6, J_FLUX[True]
                                      .joint_attention_dim),
                 pooled_projections=text(5, 1, 1, J_FLUX[True]
                                         .pooled_projection_dim)[:, 0],
                 height=32, width=32),
    "qwenimage": dict(text_embeddings=text(2, 1, 6,
                                           J_QWEN.joint_attention_dim),
                      negative_embeddings=text(3, 1, 6,
                                               J_QWEN.joint_attention_dim),
                      height=32, width=32),
}
LATENTS = {"cogvideox": (1, 3, 4, 4, 6),
           "flux": (1, J_FLUX[True].in_channels // 4, 4, 4),
           "qwenimage": (1, J_QWEN.in_channels // 4, 4, 4)}
SEED, STEPS = 4, 2


@pytest.fixture(autouse=True)
def _offline(monkeypatch):
    # the Wan directories hold no tokenizer files: both factories fall back
    # to the hash tokenizer, and must not look for one on the hub
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")


def _family_dir(root, family, with_vae=True):
    dit = {"cogvideox": lambda: cogvideox("5b")[1],
           "flux": lambda: flux(True)[1],
           "qwenimage": lambda: qwenimage()[1]}[family]()
    vae = ({"cogvideox": cogvideox_vae, "flux": kl}[family]()[1]
           if with_vae and family != "qwenimage" else None)
    return checkpoint.save_family_checkpoint_dir(str(root / family), dit,
                                                 vae)


@functools.lru_cache(maxsize=None)
def _wan_weights():
    """The tiny Wan DiT, VAE and umT5 params of `_serving_pipes.pipelines`,
    drawn once, as numpy."""
    jpipe, _ = pipelines()
    return tuple(jax.tree.map(np.asarray, p) for p in (
        jpipe.dit_params, jpipe.vae_params, jpipe.t5_params))


@pytest.fixture(scope="module")
def wan_dir(tmp_path_factory):
    """A published-layout Wan directory of those weights."""
    _, pipe = _wan_pipelines()
    path = str(tmp_path_factory.mktemp("wan") / "wan")
    checkpoint.save_wan_checkpoint_dir(path, pipe.dit, pipe.vae, pipe.t5)
    return path


def _wan_pipelines():
    """(JAX pipeline, port pipeline), fresh, on the cached weights (a
    switch deletes the JAX DiT's buffers)."""
    dp, vp, tp = _wan_weights()
    dev = lambda t: jax.tree.map(jnp.array, t)  # noqa: E731
    jpipe = JaxWan(dev(dp), DCFG, dev(vp), J_VAE, dev(tp), J_T5,
                   dtype=jnp.float32)
    vae = WanVAE(TVCFG)
    vae.load_state_dict(convert.vae_from_jax(vp))
    t5 = T5Encoder(TT5CFG)
    t5.load_state_dict(convert.t5_from_jax(tp))
    return jpipe, WanPipeline(port_dit(dp), vae, t5, dtype=torch.float32,
                              device="cpu")


def _controllers():
    """(JAX controller, port controller) on tiny Wan pipelines of the same
    weights, each with the load arguments a switch back to Wan needs."""
    jpipe, pipe = _wan_pipelines()
    jc = JController(jpipe, wan_load_kwargs=dict(
        vae_cfg=J_VAE, t5_cfg=J_T5, require_real_tokenizer=False))
    c = VideoCoFController(pipe, wan_load_kwargs=dict(
        vae_cfg=TVCFG, t5_cfg=TT5CFG, require_real_tokenizer=False))
    return jc, c


@pytest.mark.parametrize("family", FAMILIES)
def test_switch_round_trip_and_generate_media(tmp_path, wan_dir, family):
    jc, c = _controllers()
    old = c.pipeline
    path = _family_dir(tmp_path, family)
    jc.update_diffusion_transformer(path)
    c.update_diffusion_transformer(path)
    assert c.family == jc.family == family
    assert c.model_name == path and old.dit is None    # released first
    assert c.pipeline.device.type == "cpu"
    kw = dict(REQUEST[family], num_inference_steps=STEPS, seed=SEED)
    want = jc.generate_media(**kw)
    got = c.generate_media(latents=jax_latents(SEED, LATENTS[family]), **kw)
    key, other = (("videos", "images") if family == "cogvideox"
                  else ("images", "videos"))
    assert set(got) == set(want) and got[other] is None
    np.testing.assert_allclose(got[key], np.asarray(want[key]), **TOL)
    # and back to Wan, rebuilt from the directory with the load arguments
    jc.update_diffusion_transformer(wan_dir)
    c.update_diffusion_transformer(wan_dir)
    assert c.family == jc.family == "wan"
    for k, v in old.vae.state_dict().items():
        assert torch.equal(c.pipeline.vae.state_dict()[k], v), k
    with pytest.raises(RuntimeError, match="Wan"):
        c.generate_media(np.zeros((1, 4, 8), np.float32))


def test_switch_between_families(tmp_path):
    """A family to another family: a pipeline rebuild too (JAX's rule:
    any non-Wan side switches through the factory)."""
    jc, c = _controllers()
    for family in ("flux", "qwenimage"):
        path = _family_dir(tmp_path, family, with_vae=False)
        jc.update_diffusion_transformer(path)
        c.update_diffusion_transformer(path)
        assert c.family == jc.family == family
    got = c.generate_media(latents=jax_latents(SEED, LATENTS["qwenimage"]),
                           num_inference_steps=STEPS, seed=SEED,
                           **{k: v for k, v in REQUEST["qwenimage"].items()})
    assert got["images"].shape == (1, 4, 4, 4)       # latents: no VAE


@pytest.mark.parametrize("family,want_fp8", [("flux", True),
                                             ("qwenimage", True),
                                             ("cogvideox", False)])
def test_inferred_fp8_carries_to_the_large_families(tmp_path, family,
                                                   want_fp8):
    """A resident fp8 Wan with no quantize among its load arguments: the
    intent carries to Flux and QwenImage (which need it to fit) and not to
    CogVideoX, as JAX's controller decides (`controller.py:187-222`)."""
    _, c = _controllers()
    quantize_dit_fp8(c.pipeline.dit)
    c.update_diffusion_transformer(_family_dir(tmp_path, family))
    assert c._inferred_quantize == "fp8"
    assert is_fp8(c.pipeline.dit.blocks[0].attn.q) == want_fp8


# ------------------------------------------------------------------ HTTP

@contextlib.contextmanager
def serving(api_module, controller):
    server = ThreadingHTTPServer(("127.0.0.1", 0), api_module.make_handler(
        controller, threading.Lock()))
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()


def _post(url, path, payload):
    req = urllib.request.Request(url + path, data=json.dumps(payload)
                                 .encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _npy_b64(a):
    buf = io.BytesIO()
    np.save(buf, np.asarray(a, np.float32), allow_pickle=False)
    return base64.b64encode(buf.getvalue()).decode()


@pytest.mark.parametrize("family,with_vae,field", [
    ("cogvideox", True, "base64_encoding"), ("flux", True, "base64_image"),
    ("qwenimage", False, "base64_latents")])
def test_http_embeddings_in_request(tmp_path, monkeypatch, family, with_vae,
                                    field):
    """The switch over the update endpoint, then one request with the
    embeddings in an allowlisted .npz and one with base64 .npy fields: the
    same codes and reply fields from both handlers, and the port's reply
    the encoding of its own `generate_media` on the same call."""
    if family == "cogvideox":
        pytest.importorskip("cv2")
    models = tmp_path / "models"
    models.mkdir()
    monkeypatch.setenv("VIDEOCOF_MODEL_DIRS", str(models))
    monkeypatch.setenv("VIDEOCOF_ASSET_DIRS", str(models))
    path = _family_dir(models, family, with_vae)
    req = REQUEST[family]
    emb_keys = ("text_embeddings", "negative_embeddings",
                "pooled_projections")
    npz = str(models / "embeds.npz")
    np.savez(npz, **{k: req[k] for k in emb_keys if k in req})
    geo = {k: v for k, v in req.items() if k not in emb_keys}
    body = dict(geo, seed_textbox=SEED, sample_step_slider=STEPS)
    replies = {}
    for name, module, controller in (
            ("jax", japi, _controllers()[0]),
            ("port", api, _controllers()[1])):
        with serving(module, controller) as url:
            code, r = _post(url, api.UPDATE_ENDPOINT,
                            {"diffusion_transformer_path": path})
            assert (code, r["message"]) == (200, "Success"), r
            replies[name] = [
                _post(url, api.ENDPOINT, dict(body, embeddings_path=npz)),
                _post(url, api.ENDPOINT, dict(body, **{
                    k: _npy_b64(req[k]) for k in emb_keys if k in req}))]
        if name == "port":
            got = controller.generate_media(
                **{k: req[k] for k in emb_keys if k in req}, seed=SEED,
                num_inference_steps=STEPS, **geo)
    for (jcode, jr), (code, r) in zip(*replies.values()):
        assert code == jcode == 200, (r, jr)
        assert set(r) == set(jr) == {"message", "family", field}
        assert r["family"] == family
    out = got["videos"] if family == "cogvideox" else got["images"]
    encode = {"base64_encoding": VideoCoFController.encode_video_base64,
              "base64_image": VideoCoFController.encode_image_base64,
              "base64_latents": VideoCoFController.encode_array_base64}
    for _, r in replies["port"]:
        if field != "base64_encoding":     # mp4 bytes carry no fixed header
            assert r[field] == encode[field](out)


def test_http_refusals(tmp_path, monkeypatch):
    """Without embeddings: 400; an ``embeddings_path`` outside the asset
    allowlist: 403; both handlers alike, their counters too."""
    models, outside = tmp_path / "models", tmp_path / "elsewhere"
    models.mkdir()
    outside.mkdir()
    monkeypatch.setenv("VIDEOCOF_MODEL_DIRS", str(models))
    monkeypatch.setenv("VIDEOCOF_ASSET_DIRS", str(models))
    path = _family_dir(models, "flux", with_vae=False)
    np.savez(str(outside / "e.npz"), text_embeddings=np.zeros((1, 6, 32)))
    codes = {}
    for name, module, controller in (
            ("jax", japi, _controllers()[0]),
            ("port", api, _controllers()[1])):
        with serving(module, controller) as url:
            _post(url, api.UPDATE_ENDPOINT,
                  {"diffusion_transformer_path": path})
            codes[name] = [
                _post(url, api.ENDPOINT, {"height": 32})[0],
                _post(url, api.ENDPOINT,
                      {"embeddings_path": str(outside / "e.npz")})[0]]
            with urllib.request.urlopen(url + "/metrics") as r:
                metrics = r.read().decode()
            codes[name].append(
                [line for line in metrics.splitlines()
                 if line.startswith("videocof_failures_total")])
    assert codes["port"] == codes["jax"]
    assert codes["port"][:2] == [400, 403]
