"""The port's HTTP API (`videocof_torch.serving.api`) against the JAX
package's on tiny CPU pipelines of the same weights and noise, mirroring
`tests/test_serving_cli.py`: one sequence of requests (health, page, edits
with and without LoRA files and the reference's payload fields, the model
switch, every refusal) gives the same status codes, messages and counters
on both, and the arrays handed to the mp4 encoder agree; /healthz turns
degraded on a stuck generation; MoE and text-to-video requests; two
concurrent requests run one after the other. Then the web page's fields,
`VideoCoFClient`, `WorkerPool`, `init_distributed` on gloo and the
ComfyUI nodes. JAX reads clips on its cv2 path (its native libav runtime
is not ported) and runs its stepwise loop."""

import base64
import contextlib
import http.client
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import videocof_tpu.runtime as jruntime
from videocof_tpu.comfyui import NODE_CLASS_MAPPINGS as JNODES
from videocof_tpu.configs import GenerationConfig as JGen
from videocof_tpu.serving import VideoCoFController as JController
from videocof_tpu.serving import api as japi
from videocof_tpu.serving import webui as jwebui
from videocof_torch.comfyui import (NODE_CLASS_MAPPINGS,
                                    NODE_DISPLAY_NAME_MAPPINGS)
from videocof_torch.configs import GenerationConfig
from videocof_torch.serving import VideoCoFClient, VideoCoFController
from videocof_torch.serving import api, webui
from videocof_torch.serving.multihost import WorkerPool
from videocof_torch.utils import checkpoint

from _serving_pipes import (EDIT_NOISE_SHAPE, FRAMES, SIZE, TVCFG, inject,
                            lora_file, pipelines, port_pipeline, write_clip)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = "remove the dog"


@pytest.fixture(autouse=True)
def _jax_like_the_port(monkeypatch):
    monkeypatch.setenv("VIDEOCOF_STEPWISE", "1")
    monkeypatch.setenv("VIDEOCOF_FETCH_YUV420", "0")
    monkeypatch.setattr(jruntime, "_load", lambda: None)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    pytest.importorskip("cv2")
    path = write_clip(tmp_path_factory.mktemp("vid") / "in.mp4", frames=12)
    with open(path, "rb") as f:
        return path, base64.b64encode(f.read()).decode()


@contextlib.contextmanager
def serving(api_module, controller, metrics=None):
    """``api_module``'s handler in front of ``controller`` on a free port;
    yields the base URL."""
    server = ThreadingHTTPServer(("127.0.0.1", 0), api_module.make_handler(
        controller, threading.Lock(), metrics))
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=30)


def request(url, path, payload=None, raw=None, headers=None):
    """(status, body) of a GET (no payload) or a json POST; the body as
    json where it parses."""
    host, port = url.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=600)
    try:
        if payload is None and raw is None:
            conn.request("GET", path)
        else:
            body = raw if raw is not None else json.dumps(payload).encode()
            conn.request("POST", path, body=body, headers={
                "Content-Type": "application/json",
                "Content-Length": str(len(body)), **(headers or {})})
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    try:
        return resp.status, json.loads(data)
    except ValueError:
        return resp.status, data.decode()


def metric_counters(text):
    return {k: v for k, v in re.findall(
        r"^videocof_(requests_total|failures_total|busy|"
        r"generate_seconds_count|queue_wait_seconds_sum|"
        r"queue_wait_seconds_count) (\S+)$", text, re.M)}


def counters_but_wait_sum(text):
    """`metric_counters` less the queue-wait sum (a time), checked >= 0."""
    got = metric_counters(text)
    assert float(got.pop("queue_wait_seconds_sum")) >= 0.0
    return got


def _capture_encodes(controller, seen):
    """Keep the arrays the handler hands to the mp4 encoder."""
    real = controller.encode_video_base64

    def enc(video, fps=16):
        seen.append(np.asarray(video))
        return real(video, fps)
    controller.encode_video_base64 = enc


def _edit_defaults():
    return dict(source_frames=FRAMES, reasoning_frames=4,
                num_inference_steps=2, guidance_scale=1.0)


def _pair(moe=False, **defaults):
    """(JAX controller, port controller) on pipelines of the same weights,
    both with the same injected noise, each with its outputs and encoded
    arrays recorded."""
    jpipe, pipe = pipelines(moe=moe)
    rng = np.random.default_rng(0)
    noise = rng.standard_normal(EDIT_NOISE_SHAPE).astype(np.float32)
    t2v_noise = rng.standard_normal(
        (1, TVCFG.z_dim, 2, SIZE // 8, SIZE // 8)).astype(np.float32)
    sides = []
    for ctrl_cls, gen_cls, p, extra in (
            (JController, JGen, jpipe, {"fused_sampling": False}),
            (VideoCoFController, GenerationConfig, pipe, {})):
        rec = {"outputs": [], "encoded": []}
        inject(p, noise, rec["outputs"], t2v_noise=t2v_noise, **extra)
        c = ctrl_cls(p, defaults=gen_cls(**defaults))
        _capture_encodes(c, rec["encoded"])
        sides.append((c, rec))
    return sides


def _assert_same_arrays(jrec, rec):
    assert len(rec["outputs"]) == len(jrec["outputs"]) > 0
    for got, want in zip(rec["outputs"], jrec["outputs"]):
        np.testing.assert_allclose(got.latents, want.latents, rtol=2e-4,
                                   atol=2e-4)
    assert len(rec["encoded"]) == len(jrec["encoded"])
    for got, want in zip(rec["encoded"], jrec["encoded"]):
        assert got.shape == want.shape
        assert np.abs(got - want).max() * 255 <= 1.0 + 1e-3


# ------------------------------------------------------ against JAX's API

def test_request_sequence_matches_jax(clip, tmp_path, monkeypatch):
    _, vid_b64 = clip
    models = tmp_path / "models"
    models.mkdir()
    # inside the model allowlist, which the port holds LoRA files to
    lora = lora_file(str(models / "lora.safetensors"), 0)
    outside = tmp_path / "outside.mp4"
    outside.write_bytes(b"")
    monkeypatch.setenv("VIDEOCOF_MODEL_DIRS", str(models))
    monkeypatch.delenv("VIDEOCOF_ASSET_DIRS", raising=False)
    edit = {"prompt_textbox": PROMPT, "source_video": vid_b64,
            "seed_textbox": 3, "sample_step_slider": 2}
    steps = [
        ("GET", "/healthz", None),
        ("POST", api.ENDPOINT, edit),
        # the reference's other fields and a LoRA file
        ("POST", api.LEGACY_ENDPOINT, dict(
            edit, negative_prompt_textbox="blurry, low quality",
            sampler_dropdown="Flow_DPM++", lora_model_path=lora,
            lora_alpha_slider=0.8)),
        ("POST", api.ENDPOINT, dict(edit, lora_model_path="none",
                                    cfg_scale_slider=1.0)),
        ("POST", api.ENDPOINT, {"prompt_textbox": "x"}),
        ("POST", api.ENDPOINT, {"embeddings_path": "assets/embeds.npz",
                                "height": 32, "width": 32}),
        ("POST", api.ENDPOINT, {"prompt_textbox": "x",
                                "source_video_path": str(outside)}),
        ("POST", api.UPDATE_ENDPOINT,
         {"diffusion_transformer_path": str(tmp_path / "elsewhere")}),
        ("POST", api.LEGACY_UPDATE_ENDPOINT, {}),
        ("POST", api.UPDATE_ENDPOINT,
         {"diffusion_transformer_path": "none"}),
        ("POST", api.UPDATE_ENDPOINT,
         {"diffusion_transformer_path": str(models / "missing")}),
        ("POST", "/nowhere", {}),
        ("GET", "/nowhere", None),
        ("GET", "/", None),
        ("POST", api.ENDPOINT, b"{not json"),
        ("GET", "/metrics", None),
    ]
    replies = []
    for api_module, (c, rec) in zip((japi, api),
                                    _pair(**_edit_defaults())):
        with serving(api_module, c) as url:
            got = []
            for method, path, body in steps:
                if isinstance(body, bytes):
                    got.append(request(url, path, raw=body))
                else:
                    got.append(request(url, path, body))
            # an oversized body is refused before it is read
            conn = http.client.HTTPConnection(url.split("//")[1].split(":")[0],
                                              int(url.rsplit(":", 1)[1]))
            conn.putrequest("POST", api.ENDPOINT)
            conn.putheader("Content-Length", str(10 ** 12))
            conn.endheaders()
            got.append((conn.getresponse().status, None))
            conn.close()
        replies.append((got, c, rec))
    (jgot, jc, jrec), (got, c, rec) = replies
    assert [code for code, _ in got] == [code for code, _ in jgot] == [
        200, 200, 200, 200, 400, 400, 403, 403, 200, 200, 200, 404, 404, 200,
        400, 200, 413]
    paths = [path for _, path, _ in steps] + ["oversized"]
    for path, (code, body), (_, jbody) in zip(paths, got, jgot):
        if path == "/metrics":
            # JAX's server has no queue-wait summary
            port = counters_but_wait_sum(body)
            assert port.pop("queue_wait_seconds_count") == "3"
            assert port == metric_counters(jbody) == {
                "requests_total": "5", "failures_total": "2", "busy": "0",
                "generate_seconds_count": "3"}
        elif path == "/":
            assert "update_diffusion_transformer" in body
        elif isinstance(body, dict) and "message" in body:
            if body["message"].startswith("Error."):
                assert jbody["message"].startswith("Error.")
            else:
                assert body["message"] == jbody["message"], path
            assert body.get("prompt") == jbody.get("prompt")
        elif isinstance(body, dict):
            assert body == jbody
    assert "grounded" in got[1][1]["prompt"]
    assert c._merged_loras == jc._merged_loras == {}
    _assert_same_arrays(jrec, rec)
    assert len(rec["encoded"]) == 3


def test_moe_and_t2v_requests_match_jax(clip, tmp_path, monkeypatch):
    """A Wan2.2 MoE server: the full knob set (per-expert guidance,
    TeaCache, cfg-skip, sequential CFG, a LoRA file merged into both
    experts), a request that leaves cfg_sequential to the pipeline again,
    and a text-to-video request."""
    _, vid_b64 = clip
    lora = lora_file(str(tmp_path / "adapter.safetensors"), 1)
    monkeypatch.setenv("VIDEOCOF_MODEL_DIRS", str(tmp_path))
    knobs = {"prompt_textbox": PROMPT, "source_video": vid_b64,
             "seed_textbox": 3, "sample_step_slider": 4,
             "cfg_scale_slider": 5.0, "guidance_scale_2": 3.0,
             "enable_teacache": True, "teacache_threshold": 0.1,
             "num_skip_start_steps": 0, "cfg_skip_ratio": 0.25,
             "cfg_sequential": True, "lora_model_path": lora,
             "lora_alpha_slider": 0.8}
    plain = {"prompt_textbox": PROMPT, "source_video": vid_b64,
             "seed_textbox": 3, "sample_step_slider": 2,
             "cfg_scale_slider": 1.0}
    t2v = {"t2v": True, "prompt_textbox": "a red fox in the snow",
           "height": SIZE, "width": SIZE, "num_frames": 5, "seed_textbox": 3,
           "sample_step_slider": 2, "cfg_scale_slider": 5.0,
           "guidance_scale_2": 3.0}
    sides = _pair(moe=True, source_frames=FRAMES, reasoning_frames=4,
                  num_inference_steps=4, guidance_scale=5.0)
    seq = []
    for api_module, (c, rec) in zip((japi, api), sides):
        c.model_name = "Wan2.2-T2V-A14B"
        with serving(api_module, c) as url:
            code, out = request(url, api.ENDPOINT, knobs)
            assert code == 200 and out["message"] == "Success", out
            assert c._merged_loras == {lora: 0.8}
            assert c.pipeline.cfg_sequential is True
            assert request(url, api.ENDPOINT, plain)[0] == 200
            assert c.pipeline.cfg_sequential is False
            code, out = request(url, api.ENDPOINT, t2v)
            assert code == 200 and out["prompt"] == t2v["prompt_textbox"]
            seq.append(rec)
    _assert_same_arrays(*seq)
    assert seq[1]["encoded"][2].shape == (1, 3, 5, SIZE, SIZE)


# -------------------------------------------------------- the port alone

def test_healthz_degraded_on_stuck_generation():
    metrics = api.Metrics()
    with serving(api, VideoCoFController(port_pipeline()), metrics) as url:
        assert request(url, "/healthz")[1]["status"] == "ok"
        with metrics._lock:
            metrics.generating_since = time.time() - 99999
        code, body = request(url, "/healthz")
        assert code == 503 and body["status"] == "degraded"
        with metrics._lock:
            metrics.generating_since = None
        assert ("videocof_generating_for_seconds 0.0"
                in request(url, "/metrics")[1])


def test_update_endpoint_swaps_in_place(tmp_path, monkeypatch):
    pipe = port_pipeline()
    c = VideoCoFController(pipe)
    other = port_pipeline(seed=1).dit
    ckpt = str(tmp_path / "dit_v2")
    checkpoint.save_dit_checkpoint_dir(ckpt, other, other.cfg)
    with serving(api, c) as url:
        monkeypatch.delenv("VIDEOCOF_MODEL_DIRS", raising=False)
        code, _ = request(url, api.UPDATE_ENDPOINT,
                          {"diffusion_transformer_path": ckpt})
        assert code == 403
        assert not torch.equal(pipe.dit.patch_embed.weight,
                               other.patch_embed.weight)
        monkeypatch.setenv("VIDEOCOF_MODEL_DIRS", str(tmp_path))
        c._merged_loras["stale"] = 1.0
        code, body = request(url, api.LEGACY_UPDATE_ENDPOINT,
                             {"diffusion_transformer_path": ckpt})
        assert code == 200 and body["message"] == "Success"
        assert c._merged_loras == {}
        for k, v in other.state_dict().items():
            assert torch.equal(pipe.dit.state_dict()[k], v), k


def test_lora_path_outside_model_dirs_is_refused(clip, tmp_path,
                                                 monkeypatch):
    """A request's ``lora_model_path`` is read only inside
    VIDEOCOF_MODEL_DIRS (the JAX handler reads any path): outside it, or
    through a link that leads out of it, the reply is 403, counted as a
    failed request, and nothing is read or generated; "none" needs no
    allowlist."""
    _, vid_b64 = clip
    models, elsewhere = tmp_path / "models", tmp_path / "elsewhere"
    models.mkdir()
    elsewhere.mkdir()
    outside = lora_file(str(elsewhere / "adapter.safetensors"), 0)
    inside = lora_file(str(models / "adapter.safetensors"), 0)
    link = models / "link.safetensors"
    link.symlink_to(outside)
    c = VideoCoFController(port_pipeline(), defaults=GenerationConfig(
        **_edit_defaults()))
    read, generated = [], []
    real_lora, real_gen = c.ensure_lora, c.generate
    monkeypatch.setattr(c, "ensure_lora", lambda *a: (
        read.append(a), real_lora(*a))[1])
    monkeypatch.setattr(c, "generate", lambda **kw: (
        generated.append(1), real_gen(**kw))[1])
    edit = {"prompt_textbox": PROMPT, "source_video": vid_b64,
            "seed_textbox": 3, "sample_step_slider": 1}
    metrics = api.Metrics()
    with serving(api, c, metrics) as url:
        monkeypatch.delenv("VIDEOCOF_MODEL_DIRS", raising=False)
        refused = [request(url, api.ENDPOINT, dict(edit, lora_model_path=p))
                   for p in (outside, inside)]
        monkeypatch.setenv("VIDEOCOF_MODEL_DIRS", str(models))
        refused += [request(url, api.ENDPOINT, dict(edit, lora_model_path=p))
                    for p in (outside, str(link))]
        assert [code for code, _ in refused] == [403] * 4
        assert all(body["message"] == "lora_model_path outside "
                   "VIDEOCOF_MODEL_DIRS" for _, body in refused)
        assert read == [] and generated == [] and c._merged_loras == {}
        for p in (inside, "none"):
            code, body = request(url, api.ENDPOINT,
                                 dict(edit, lora_model_path=p))
            assert code == 200 and body["message"] == "Success", body
        assert read == [(inside, 1.0), (None, 1.0)]
        assert c._merged_loras == {}
        text = request(url, "/metrics")[1]
    assert counters_but_wait_sum(text) == {
        "requests_total": "6", "failures_total": "4", "busy": "0",
        "generate_seconds_count": "2", "queue_wait_seconds_count": "2"}


def test_concurrent_requests_serialize(clip, monkeypatch):
    _, vid_b64 = clip
    c = VideoCoFController(port_pipeline(), defaults=GenerationConfig(
        **_edit_defaults()))
    metrics = api.Metrics()
    active, max_active, busy_seen = [0], [0], []
    real = c.generate

    def tracked(*a, **kw):
        active[0] += 1
        max_active[0] = max(max_active[0], active[0])
        try:
            time.sleep(0.3)         # widen any would-be overlap
            with metrics._lock:
                busy_seen.append(metrics.busy)
            return real(*a, **kw)
        finally:
            active[0] -= 1
    monkeypatch.setattr(c, "generate", tracked)
    payload = {"prompt_textbox": PROMPT, "source_video": vid_b64,
               "seed_textbox": 3, "sample_step_slider": 2}
    results = [None, None]
    with serving(api, c, metrics) as url:
        def post(i):
            results[i] = request(url, api.ENDPOINT, payload)
        threads = [threading.Thread(target=post, args=(i,)) for i in (0, 1)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        assert not any(th.is_alive() for th in threads)
        text = request(url, "/metrics")[1]
    assert all(r[0] == 200 and r[1]["message"] == "Success" for r in results)
    assert max_active[0] == 1, "generations overlapped past the lock"
    assert max(busy_seen) >= 1
    assert counters_but_wait_sum(text) == {
        "requests_total": "2", "failures_total": "0", "busy": "0",
        "generate_seconds_count": "2", "queue_wait_seconds_count": "2"}


def test_queue_wait_summary_times_the_wait_for_the_lock(clip, monkeypatch,
                                                        tmp_path):
    """Two concurrent requests against a controller that sleeps: the second
    waits for the first's generation, so the wait sum is non-zero; each
    generation is a ``videocof.request`` span on a trace of all threads."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    _, vid_b64 = clip
    c = VideoCoFController(port_pipeline(), defaults=GenerationConfig(
        **_edit_defaults()))
    metrics = api.Metrics()

    def sleeping(*a, **kw):
        time.sleep(0.3)
        return {"videos": np.zeros((1, 3, 1, 8, 8), np.float32),
                "prompt": kw.get("prompt", "")}
    monkeypatch.setattr(c, "generate", sleeping)
    monkeypatch.setattr(c, "encode_video_base64", lambda *a, **k: "")
    payload = {"prompt_textbox": PROMPT, "source_video": vid_b64}
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        with serving(api, c, metrics) as url:
            threads = [threading.Thread(target=request,
                                        args=(url, api.ENDPOINT, payload))
                       for _ in range(2)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in threads)
            got = metric_counters(request(url, "/metrics")[1])
    assert got["queue_wait_seconds_count"] == "2"
    assert float(got["queue_wait_seconds_sum"]) >= 0.2
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert [ev["name"] for ev in events if ev.get("cat") == "user_annotation"
            and ev["name"] == "videocof.request"] == ["videocof.request"] * 2


def test_webui_exposes_the_same_form():
    page = webui.INDEX_HTML
    for field in ("lora_model_path", "lora_alpha_slider", "enable_teacache",
                  "teacache_threshold", "num_skip_start_steps",
                  "cfg_skip_ratio", "sampler_dropdown",
                  "negative_prompt_textbox", "guidance_scale_2",
                  "update_diffusion_transformer", "Flow_Unipc",
                  "Flow_DPM++", api.ENDPOINT, api.UPDATE_ENDPOINT):
        assert field in page, field
    ids = lambda html: re.findall(r'id="([^"]+)"', html)  # noqa: E731
    assert ids(page) == ids(jwebui.INDEX_HTML)
    sent = lambda html: set(re.findall(r"^\s+(\w+): ", html, re.M))  # noqa
    assert sent(page) == sent(jwebui.INDEX_HTML)


def test_client_post_to_host_saves_the_mp4(clip, tmp_path):
    import cv2
    path, _ = clip
    c = VideoCoFController(port_pipeline(), defaults=GenerationConfig(
        **_edit_defaults()))
    with serving(api, c) as url:
        out = VideoCoFClient(url, timeout=600).post_to_host(
            PROMPT, video_path=path, save_path=str(tmp_path / "o" / "e.mp4"),
            seed_textbox=1, sample_step_slider=1)
        assert out["message"] == "Success" and len(out["video_bytes"]) > 100
        cap = cv2.VideoCapture(str(tmp_path / "o" / "e.mp4"))
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        hw = (int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
              int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)))
        cap.release()
        assert (n, hw) == (FRAMES + 1, (SIZE, SIZE))   # ground + edit
        with pytest.raises(urllib.error.HTTPError) as err:   # no video
            VideoCoFClient(url).post_to_host(
                PROMPT, video_b64="", save_path=str(tmp_path / "x.mp4"))
        assert err.value.code == 400
        assert not (tmp_path / "x.mp4").exists()
    with pytest.raises(ValueError):
        VideoCoFClient(url).post_to_host(PROMPT)


def test_worker_pool_over_two_servers_and_a_dead_endpoint(clip):
    _, vid_b64 = clip
    controllers = [VideoCoFController(port_pipeline(seed=s),
                                      defaults=GenerationConfig(
                                          **_edit_defaults()))
                   for s in (0, 1)]
    served = [0, 0]
    for i, c in enumerate(controllers):
        real = c.generate

        def counted(*a, i=i, real=real, **kw):
            served[i] += 1
            return real(*a, **kw)
        c.generate = counted
    with serving(api, controllers[0]) as u1, \
            serving(api, controllers[1]) as u2:
        dead = "http://127.0.0.1:9"            # the discard port: refused
        pool = WorkerPool([u1, u2, dead], timeout=600, max_retries=1)
        assert pool.healthy() == [u1, u2]
        payloads = [{"prompt_textbox": f"p{i}", "source_video": vid_b64,
                     "seed_textbox": i, "sample_step_slider": 1}
                    for i in range(4)]
        out = WorkerPool([u1, u2], timeout=600).map(payloads)
        assert [o["message"] for o in out] == ["Success"] * 4
        assert all(f"p{i}" in o["prompt"] for i, o in enumerate(out))
        assert served[0] >= 1 and served[1] >= 1 and sum(served) == 4
        failed = WorkerPool([dead], timeout=5, max_retries=1).map(
            payloads[:1])
        assert failed[0]["message"].startswith("error:")


def test_init_distributed_gloo_world_of_one():
    """In a subprocess, so no process group outlives the test."""
    code = (
        "import socket, torch\n"
        "import torch.distributed as dist\n"
        "from videocof_torch.serving.multihost import init_distributed\n"
        "s = socket.socket(); s.bind(('127.0.0.1', 0))\n"
        "port = s.getsockname()[1]; s.close()\n"
        "init_distributed(f'127.0.0.1:{port}', 1, 0)\n"
        "assert dist.get_backend() == 'gloo' and dist.get_world_size() == 1\n"
        "t = torch.ones(3)\n"
        "dist.all_reduce(t)\n"
        "assert t.tolist() == [1.0, 1.0, 1.0]\n"
        "dist.destroy_process_group()\n"
        "try:\n"
        "    init_distributed('127.0.0.1:1', None, 0)\n"
        "except ValueError:\n"
        "    print('refused')\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "refused"


def test_comfyui_nodes_match_jax():
    assert set(NODE_CLASS_MAPPINGS) == set(NODE_DISPLAY_NAME_MAPPINGS) == set(
        JNODES)
    for name, cls in NODE_CLASS_MAPPINGS.items():
        jcls = JNODES[name]
        assert cls.INPUT_TYPES() == jcls.INPUT_TYPES()
        assert (cls.RETURN_TYPES, cls.FUNCTION) == (jcls.RETURN_TYPES,
                                                    jcls.FUNCTION)
    (jc, jrec), (c, rec) = _pair()
    frames = np.random.default_rng(0).uniform(
        0, 1, (FRAMES, SIZE, SIZE, 3)).astype(np.float32)
    kw = dict(steps=2, guidance_scale=1.0, seed=3, reasoning_frames=4)
    (want,) = JNODES["VideoCoFEdit"]().edit(jc.pipeline, frames, PROMPT, **kw)
    (got,) = NODE_CLASS_MAPPINGS["VideoCoFEdit"]().edit(
        c.pipeline, torch.from_numpy(frames), PROMPT, **kw)
    assert isinstance(got, torch.Tensor)
    assert tuple(got.shape) == (FRAMES, SIZE, SIZE, 3)
    assert 0.0 <= got.min() and got.max() <= 1.0
    assert np.abs(got.numpy() - np.asarray(want)).max() * 255 <= 1.0 + 1e-3
    _assert_same_arrays({**jrec, "encoded": []}, {**rec, "encoded": []})
    (full,) = NODE_CLASS_MAPPINGS["VideoCoFEdit"]().edit(
        c.pipeline, frames, PROMPT, return_reasoning=True, **kw)
    assert tuple(full.shape) == (FRAMES + 1, SIZE, SIZE, 3)   # numpy wire


def test_comfyui_loader_caches_one_pipeline(monkeypatch):
    from videocof_torch import factory
    from videocof_torch.comfyui.comfyui_nodes import VideoCoFModelLoader
    built = []

    def load(model_name, **kw):
        built.append((model_name, kw))
        return object()
    monkeypatch.setattr(factory, "load_pipeline", load)
    monkeypatch.setattr(VideoCoFModelLoader, "_cache_key", ())
    monkeypatch.setattr(VideoCoFModelLoader, "_cache_pipe", None)
    loader = VideoCoFModelLoader()
    (a,) = loader.load("", "none", True)
    (b,) = VideoCoFModelLoader().load("", "none", True)
    (q,) = loader.load("", "fp8", True)
    assert a is b and q is not a
    assert built == [("", {"random_init": True, "quantize": None}),
                     ("", {"random_init": True, "quantize": "fp8"})]
