"""HTTP inference API: the twin of the reference's FastAPI endpoint
(`videox_fun/api/api.py:90-226`: ``POST /videox_fun/infer_forward`` json ->
controller.generate -> base64 mp4), on the standard library's http.server.

Counterpart of `videocof_tpu/serving/api.py`, with its endpoints, status
codes, payload fields, counters and environment variables:
``VIDEOCOF_MAX_BODY_BYTES`` (the largest request body, default 512 MiB),
``VIDEOCOF_ASSET_DIRS`` (directories ``source_video_path`` may name, beside
``assets/``), ``VIDEOCOF_MODEL_DIRS`` (directories the model switch and a
request's ``lora_model_path`` may load from; empty: both refused with 403,
where the JAX package reads any LoRA path) and ``VIDEOCOF_STUCK_AFTER``
(seconds of one generation after which ``/healthz`` answers 503).

Request json:
  {"prompt_textbox": str, "source_video": <base64 mp4> | "source_video_path":
   str, "seed_textbox": int, "sample_step_slider": int,
   "cfg_scale_slider": float, "source_frames": int, "reasoning_frames": int}
Response json:
  {"message": "Success", "prompt": str, "base64_encoding": <base64 mp4>}

With a CogVideoX, Flux or QwenImage pipeline resident (after a switch by
the update endpoint) the request carries precomputed text embeddings:
  {"text_embeddings": <base64 .npy>, "negative_embeddings": ...,
   "pooled_projections": ... (Flux)} or {"embeddings_path": <.npz inside
   the asset allowlist>}, with "height", "width", "num_frames"
   (CogVideoX), "seed_textbox", "sample_step_slider", "cfg_scale_slider";
and the reply carries "base64_encoding" (an mp4, CogVideoX),
"base64_image" (a png) or "base64_latents" (.npy, no VAE resident).

Run on the card:
    python -m videocof_torch.serving.api --random_init --port 8188
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import json
import os
import sys
import tempfile
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..utils.profiling import span
from .controller import VideoCoFController

ENDPOINT = "/videocof/infer_forward"
LEGACY_ENDPOINT = "/videox_fun/infer_forward"
# model-switch endpoint (`videox_fun/api/api.py:23-39`)
UPDATE_ENDPOINT = "/videocof/update_diffusion_transformer"
LEGACY_UPDATE_ENDPOINT = "/videox_fun/update_diffusion_transformer"
MAX_BODY_BYTES = int(os.environ.get("VIDEOCOF_MAX_BODY_BYTES",
                                    512 * 1024 * 1024))


class Metrics:
    """The server's counters, in Prometheus text format at GET /metrics."""

    def __init__(self):
        self._lock = threading.Lock()
        self.started = time.time()
        self.requests_total = 0
        self.failures_total = 0
        self.busy = 0                     # generations in flight or queued
        self.generating_since = None      # wall time the running one began
        self.generate_seconds_sum = 0.0
        self.generate_seconds_count = 0
        # from a request's arrival at the generation lock to taking it
        self.queue_wait_seconds_sum = 0.0
        self.queue_wait_seconds_count = 0

    def stuck_seconds(self) -> float:
        """How long the running generation has run (0 when idle): a wedged
        device blocks without an error, and /healthz reports it."""
        with self._lock:
            t0 = self.generating_since
        return 0.0 if t0 is None else time.time() - t0

    @contextlib.contextmanager
    def generating(self, lock):
        """Hold ``lock`` (one generation at a time per card) around the
        block, which runs inside the ``videocof.request`` span: ``busy``
        counts the request from its arrival, the wait for the lock goes
        into the queue-wait summary, and ``busy`` drops before the reply,
        so a client that has its reply reads a settled gauge."""
        with self._lock:
            self.busy += 1
        arrived = time.perf_counter()
        try:
            with lock:
                with self._lock:
                    self.queue_wait_seconds_sum += \
                        time.perf_counter() - arrived
                    self.queue_wait_seconds_count += 1
                    self.generating_since = time.time()
                try:
                    with span("videocof.request"):
                        yield
                finally:
                    with self._lock:
                        self.generating_since = None
        finally:
            with self._lock:
                self.busy -= 1

    def observe(self, seconds: float, ok: bool):
        with self._lock:
            self.requests_total += 1
            if not ok:
                self.failures_total += 1
            else:
                self.generate_seconds_sum += seconds
                self.generate_seconds_count += 1

    def render(self) -> str:
        with self._lock:
            now = time.time()
            since = self.generating_since
            lines = [
                "# TYPE videocof_requests_total counter",
                f"videocof_requests_total {self.requests_total}",
                "# TYPE videocof_failures_total counter",
                f"videocof_failures_total {self.failures_total}",
                "# TYPE videocof_busy gauge",
                f"videocof_busy {self.busy}",
                "# TYPE videocof_generate_seconds summary",
                f"videocof_generate_seconds_sum "
                f"{self.generate_seconds_sum:.3f}",
                f"videocof_generate_seconds_count "
                f"{self.generate_seconds_count}",
                "# TYPE videocof_queue_wait_seconds summary",
                f"videocof_queue_wait_seconds_sum "
                f"{self.queue_wait_seconds_sum:.3f}",
                f"videocof_queue_wait_seconds_count "
                f"{self.queue_wait_seconds_count}",
                "# TYPE videocof_uptime_seconds gauge",
                f"videocof_uptime_seconds {now - self.started:.1f}",
                "# TYPE videocof_generating_for_seconds gauge",
                f"videocof_generating_for_seconds "
                f"{0.0 if since is None else now - since:.1f}",
            ]
        return "\n".join(lines) + "\n"


def _allowed_roots():
    """Directories the API may read ``source_video_path`` from: the repo's
    assets/, the working directory's assets/ and VIDEOCOF_ASSET_DIRS
    (os.pathsep separated). No temporary directory: uploads are staged
    there, and a peer must not read another's."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    roots = [os.path.join(here, "assets"),
             os.path.join(os.getcwd(), "assets")]
    roots += os.environ.get("VIDEOCOF_ASSET_DIRS", "").split(os.pathsep)
    return roots


def _model_roots():
    """Directories the model switch and a request's ``lora_model_path`` may
    load weights from: VIDEOCOF_MODEL_DIRS (os.pathsep separated), empty by
    default, so remote weight swaps and LoRA files are off until the
    operator names them (the reference's endpoints take any server-side
    path)."""
    dirs = os.environ.get("VIDEOCOF_MODEL_DIRS", "")
    return [d for d in dirs.split(os.pathsep) if d]


def _inside(path: str, roots) -> bool:
    real = os.path.realpath(path)
    return any(real == r or real.startswith(r + os.sep)
               for r in (os.path.realpath(r) for r in roots if r))


def make_handler(controller: VideoCoFController, lock: threading.Lock,
                 metrics: Metrics = None):
    """The request handler class of a server in front of ``controller``;
    ``lock`` serializes the generations and swaps on its pipeline."""
    metrics = metrics or Metrics()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            print("[api]", fmt % args, file=sys.stderr)

        def _send(self, code: int, body: bytes, content_type: str):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply(self, code: int, payload: dict):
            self._send(code, json.dumps(payload).encode(), "application/json")

        def _read_json(self, too_large: str):
            """The request's json body, or None after replying 413 (body
            over MAX_BODY_BYTES) or 400 (unreadable)."""
            try:
                n = int(self.headers.get("Content-Length", "0"))
                if n > MAX_BODY_BYTES:
                    self._reply(413, {"message": too_large.format(n=n)})
                    return None
                return json.loads(self.rfile.read(n) or b"{}")
            except Exception as e:
                self._reply(400, {"message": f"bad request: {e}"})
                return None

        def do_GET(self):
            if self.path == "/healthz":
                stuck = metrics.stuck_seconds()
                limit = float(os.environ.get("VIDEOCOF_STUCK_AFTER", "1800"))
                if stuck > limit:
                    self._reply(503, {"status": "degraded",
                                      "generating_for_s": round(stuck, 1)})
                else:
                    self._reply(200, {"status": "ok",
                                      "generating_for_s": round(stuck, 1)})
            elif self.path == "/metrics":
                self._send(200, metrics.render().encode(),
                           "text/plain; version=0.0.4")
            elif self.path in ("/", "/index.html"):
                from .webui import INDEX_HTML
                self._send(200, INDEX_HTML.encode(),
                           "text/html; charset=utf-8")
            else:
                self._reply(404, {"message": "not found"})

        def _update_transformer(self):
            """The model switch (`videox_fun/api/api.py:23-39`): body
            {"diffusion_transformer_path": ...} swaps the DiT weights; the
            reply is 200 with "Success" or "Error. error information is
            ...", and 'none' is a no-op."""
            req = self._read_json("request body too large")
            if req is None:
                return
            path = req.get("diffusion_transformer_path", "none")
            if path and path != "none":
                if not _inside(str(path), _model_roots()):
                    self._reply(403, {"message":
                                      "diffusion_transformer_path outside "
                                      "VIDEOCOF_MODEL_DIRS (remote weight "
                                      "swap requires an operator allowlist)"})
                    return
                path = os.path.realpath(str(path))
            try:
                with lock:  # a swap excludes generations in flight
                    controller.update_diffusion_transformer(path)
                self._reply(200, {"message": "Success"})
            except Exception as e:
                traceback.print_exc()
                self._reply(200, {"message":
                                  f"Error. error information is {e}"})

        def _infer_media(self, req: dict, t0: float):
            """Generation of the non-Wan families (controller.family
            'cogvideox', 'flux' or 'qwenimage') from precomputed text
            embeddings: base64 .npy fields (``text_embeddings``,
            ``negative_embeddings``, ``pooled_projections``) or an ``.npz``
            with those keys at ``embeddings_path``, read only inside the
            asset allowlist (403 outside). Replies ``base64_encoding`` (an
            mp4) for video, ``base64_image`` (a png) for a decoded image,
            ``base64_latents`` (.npy) when no VAE is resident."""
            import io

            import numpy as np

            def npy(s):
                return np.load(io.BytesIO(base64.b64decode(s)),
                               allow_pickle=False)

            try:
                emb = neg = pooled = None
                if req.get("embeddings_path"):
                    if not _inside(str(req["embeddings_path"]),
                                   _allowed_roots()):
                        metrics.observe(0.0, ok=False)
                        self._reply(403, {"message":
                                          "embeddings_path outside the "
                                          "allowed asset directories"})
                        return
                    with np.load(os.path.realpath(req["embeddings_path"]),
                                 allow_pickle=False) as z:
                        emb = z["text_embeddings"]
                        neg = (z["negative_embeddings"]
                               if "negative_embeddings" in z else None)
                        pooled = (z["pooled_projections"]
                                  if "pooled_projections" in z else None)
                if req.get("text_embeddings"):
                    emb = npy(req["text_embeddings"])
                if req.get("negative_embeddings"):
                    neg = npy(req["negative_embeddings"])
                if req.get("pooled_projections"):
                    pooled = npy(req["pooled_projections"])
                if emb is None:
                    metrics.observe(0.0, ok=False)
                    self._reply(400, {"message":
                                      "missing text_embeddings (base64 "
                                      ".npy) or embeddings_path (.npz)"})
                    return
                family = controller.family
                kwargs = dict(
                    text_embeddings=emb, negative_embeddings=neg,
                    seed=int(req.get("seed_textbox", 0)),
                    num_inference_steps=int(req["sample_step_slider"])
                    if "sample_step_slider" in req else None,
                    guidance_scale=float(req["cfg_scale_slider"])
                    if "cfg_scale_slider" in req else None)
                if family == "flux":
                    kwargs["pooled_projections"] = pooled
                for k in ("height", "width"):
                    if k in req:
                        kwargs[k] = int(req[k])
                if family == "cogvideox":
                    if "num_frames" in req:
                        kwargs["num_frames"] = int(req["num_frames"])
                    if "sampler_dropdown" in req:
                        kwargs["scheduler"] = "ddim"   # the one it serves
                with metrics.generating(lock):
                    result = controller.generate_media(**kwargs)
                reply = {"message": "Success", "family": family}
                if result.get("videos") is not None:
                    reply["base64_encoding"] = \
                        controller.encode_video_base64(result["videos"])
                else:
                    img = np.asarray(result["images"])
                    if img.ndim >= 3 and img.shape[-3] == 3:
                        reply["base64_image"] = \
                            controller.encode_image_base64(img)
                    else:     # latents: no VAE resident
                        reply["base64_latents"] = \
                            controller.encode_array_base64(img)
                metrics.observe(time.time() - t0, ok=True)
                self._reply(200, reply)
            except Exception as e:
                traceback.print_exc()
                metrics.observe(time.time() - t0, ok=False)
                self._reply(500, {"message": f"error: {e}"})

        def do_POST(self):
            if self.path in (UPDATE_ENDPOINT, LEGACY_UPDATE_ENDPOINT):
                self._update_transformer()
                return
            if self.path not in (ENDPOINT, LEGACY_ENDPOINT):
                self._reply(404, {"message": "not found"})
                return
            req = self._read_json("request body too large ({n} > "
                                  f"{MAX_BODY_BYTES} bytes)")
            if req is None:
                return
            t0 = time.time()
            if controller.family != "wan":
                # CogVideoX, Flux, QwenImage: the embeddings-in contract
                self._infer_media(req, t0)
                return
            if req.get("embeddings_path") or req.get("text_embeddings"):
                # the embeddings-in contract against a Wan pipeline: name
                # the mismatch rather than fail on the missing video
                self._reply(400, {"message": "embeddings-in payload but the "
                                  "resident pipeline is Wan; switch to a "
                                  "CogVideoX/Flux/QwenImage checkpoint via "
                                  "update_diffusion_transformer first"})
                return
            tmp = None
            try:
                kwargs = dict(
                    prompt=req.get("prompt_textbox", ""),
                    seed=int(req.get("seed_textbox", 0)),
                    num_inference_steps=int(req["sample_step_slider"])
                    if "sample_step_slider" in req else None,
                    guidance_scale=float(req["cfg_scale_slider"])
                    if "cfg_scale_slider" in req else None,
                    source_frames=req.get("source_frames"),
                    reasoning_frames=req.get("reasoning_frames"),
                    negative_prompt=req.get("negative_prompt_textbox"),
                )
                # the reference's sampler_dropdown names -> scheduler keys
                if req.get("sampler_dropdown"):
                    s = str(req["sampler_dropdown"]).lower()
                    kwargs["sampler"] = ("unipc" if "unipc" in s
                                         else "dpm++" if "dpm" in s
                                         else "euler")
                # TeaCache and cfg-skip, the reference's field names
                # (`videox_fun/api/api.py:123-127`)
                if "enable_teacache" in req:
                    kwargs["enable_teacache"] = bool(req["enable_teacache"])
                if "teacache_threshold" in req:
                    kwargs["teacache_threshold"] = float(
                        req["teacache_threshold"])
                if "num_skip_start_steps" in req:
                    kwargs["teacache_skip_start_steps"] = int(
                        req["num_skip_start_steps"])
                if "cfg_skip_ratio" in req:
                    kwargs["cfg_skip_ratio"] = float(req["cfg_skip_ratio"])
                if "cfg_sequential" in req:
                    kwargs["cfg_sequential"] = bool(req["cfg_sequential"])
                # the MoE's guidance of its high-noise steps
                # (`pipeline_wan2_2.py:552-553`)
                if ("guidance_scale_2" in req and
                        getattr(controller.pipeline, "dit_2",
                                None) is not None):
                    kwargs["guidance_scale_2"] = float(
                        req["guidance_scale_2"])
                # the LoRA set, applied under the generation lock below;
                # "none" removes it (the reference controller's semantics).
                # A file is read only inside the model allowlist: the JAX
                # handler opens any path the client names
                lora_req = None
                if "lora_model_path" in req:
                    p = req["lora_model_path"]
                    if p and p != "none":
                        if not _inside(str(p), _model_roots()):
                            metrics.observe(0.0, ok=False)
                            self._reply(403, {"message":
                                              "lora_model_path outside "
                                              "VIDEOCOF_MODEL_DIRS"})
                            return
                        p = os.path.realpath(str(p))
                    lora_req = (None if not p or p == "none" else p,
                                float(req.get("lora_alpha_slider", 1.0)))
                t2v = bool(req.get("t2v"))
                if t2v:
                    for k in ("height", "width", "num_frames"):
                        if k in req:
                            kwargs[k] = int(req[k])
                    for k in ("source_frames", "reasoning_frames"):
                        kwargs.pop(k, None)
                elif req.get("source_video"):
                    tmp = tempfile.NamedTemporaryFile(suffix=".mp4",
                                                      delete=False)
                    tmp.write(base64.b64decode(req["source_video"]))
                    tmp.close()
                    kwargs["video_path"] = tmp.name
                elif req.get("source_video_path"):
                    # server-side reads only inside the asset allowlist
                    if not _inside(req["source_video_path"],
                                   _allowed_roots()):
                        metrics.observe(0.0, ok=False)
                        self._reply(403, {"message":
                                          "source_video_path outside the "
                                          "allowed asset directories"})
                        return
                    kwargs["video_path"] = os.path.realpath(
                        req["source_video_path"])
                else:
                    metrics.observe(0.0, ok=False)
                    self._reply(400, {"message":
                                      "missing source_video[_path]"})
                    return
                with metrics.generating(lock):
                    if lora_req is not None:
                        controller.ensure_lora(*lora_req)
                    result = (controller.generate_t2v(**kwargs) if t2v
                              else controller.generate(**kwargs))
                enc = controller.encode_video_base64(result["videos"])
                metrics.observe(time.time() - t0, ok=True)
                self._reply(200, {"message": "Success",
                                  "prompt": result["prompt"],
                                  "base64_encoding": enc})
            except Exception as e:
                traceback.print_exc()
                metrics.observe(time.time() - t0, ok=False)
                self._reply(500, {"message": f"error: {e}"})
            finally:
                # the uploaded clip must not outlive the request
                if tmp is not None:
                    try:
                        os.unlink(tmp.name)
                    except OSError:
                        pass

    return Handler


def serve(controller: VideoCoFController, host: str = "127.0.0.1",
          port: int = 8188):
    server = ThreadingHTTPServer((host, port),
                                 make_handler(controller, threading.Lock()))
    print(f"[api] listening on {host}:{port}{ENDPOINT}", file=sys.stderr,
          flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_name", type=str, default=None)
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--quantize", type=str, default=None,
                   choices=[None, "fp8"])
    p.add_argument("--offload_t5", action="store_true")
    # Wan2.2 MoE: the factory finds low_noise_model/ + high_noise_model/
    # in --model_name; these override
    p.add_argument("--high_noise_model", type=str, default=None)
    p.add_argument("--boundary", type=float, default=0.875)
    p.add_argument("--port", type=int, default=8188)
    # loopback by default: the surface has no authentication; pass
    # --host 0.0.0.0 to expose it
    p.add_argument("--host", type=str, default="127.0.0.1")
    args = p.parse_args(argv)

    from ..factory import load_pipeline
    load_kwargs = dict(random_init=args.random_init, quantize=args.quantize,
                       offload_t5=args.offload_t5,
                       high_noise_model=args.high_noise_model,
                       boundary=args.boundary)
    pipe = load_pipeline(args.model_name or "", **load_kwargs)
    # a switch back to Wan from another family rebuilds with these
    serve(VideoCoFController(pipe, model_name=args.model_name,
                             wan_load_kwargs=load_kwargs),
          host=args.host, port=args.port)


if __name__ == "__main__":
    main()
