"""Serving controller: owns the resident pipeline, keeps track of the LoRA
files fused into (or attached to) it, swaps its DiT weights, builds the CoT
prompt, runs the edit and encodes the result for transport.

Counterpart of `videocof_tpu/serving/controller.py` (the reference's
`Wan_Controller` / `VideoCoF_Controller`, `videox_fun/ui/wan_ui.py:43-147`,
`examples/app.py:157-349`). LoRA files are merged in place into every
expert of a bf16 or fp32 Wan pipeline, and attached as runtime adapters to
fp8 experts (`merge_lora` refuses fp8 weights). A weight swap within Wan
copies a checkpoint into the resident DiT tensor by tensor, re-quantizing
fp8 experts on the way in, so the card never holds a second model. A swap
to a CogVideoX, Flux or QwenImage checkpoint (or from one, back to Wan)
replaces the pipeline through the factory, the old one released first
(`_switch_family_pipeline`); those families then answer `generate_media`
from precomputed text embeddings.
"""

from __future__ import annotations

import base64
import io
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs import GenerationConfig
from ..data.instructions import build_cot_prompt
from ..utils.video_io import load_video_frames, save_video


@dataclass
class VideoCoFController:
    pipeline: Any
    defaults: GenerationConfig = field(default_factory=GenerationConfig)
    # checkpoint name or path the pipeline was loaded from; picks the
    # TeaCache coefficient set by alias, as the reference UI does
    # (`videox_fun/api/api.py:224`)
    model_name: Optional[str] = None
    # {LoRA path: multiplier} fused into (or attached to) the experts
    _merged_loras: Dict[str, float] = field(default_factory=dict)
    # the pipeline's own cfg_sequential (read at the first request); a
    # request without the knob gets it back, so no setting leaks into the
    # next request
    _cfg_seq_default: Optional[bool] = None
    # `factory.load_pipeline` keyword arguments the resident Wan pipeline
    # was built with (quantize, offload_t5, random_init, ...): a switch back
    # to Wan from another family rebuilds with them
    wan_load_kwargs: Dict[str, Any] = field(default_factory=dict)
    # fp8 inferred from the resident Wan weights when wan_load_kwargs names
    # no quantize: it carries to a Wan round trip and to Flux and QwenImage
    # (as JAX's controller carries it), not to CogVideoX
    _inferred_quantize: Optional[str] = None

    @property
    def family(self) -> str:
        """The resident pipeline's model family: 'wan' (every Wan
        pipeline), 'cogvideox', 'flux' or 'qwenimage'."""
        from ..pipeline import (CogVideoXPipeline, FluxPipeline,
                                QwenImagePipeline)
        for cls, name in ((CogVideoXPipeline, "cogvideox"),
                          (FluxPipeline, "flux"),
                          (QwenImagePipeline, "qwenimage")):
            if isinstance(self.pipeline, cls):
                return name
        return "wan"

    def _wan_pipeline(self):
        from ..pipeline import WanPipeline
        if not isinstance(self.pipeline, WanPipeline):
            raise TypeError(
                f"LoRA and weight swaps serve the Wan pipelines; the "
                f"resident pipeline is a {type(self.pipeline).__name__}")
        return self.pipeline

    def _params_quantized(self) -> bool:
        """True when the experts store their weights in fp8."""
        from ..utils.fp8 import is_fp8
        return is_fp8(self._wan_pipeline().dit.blocks[0].self_attn.q)

    # ---------------------------------------------------------------- LoRA
    def ensure_lora(self, path: Optional[str], multiplier: float = 1.0):
        """Make EXACTLY ``{path: multiplier}`` (nothing for ``None``) the
        LoRA set of the pipeline. bf16 and fp32 experts: what no longer
        belongs is unmerged, then what is new is merged, in place, on every
        expert in lockstep. fp8 experts: the set is attached as runtime
        adapters (`load_runtime_lora`, `set_runtime_lora`); modules outside
        the blocks cannot ride them and are skipped with a warning. The
        caller holds the generation lock: this mutates the weights."""
        from ..models.lora import load_runtime_lora, merge_lora, unmerge_lora
        pipe = self._wan_pipeline()
        want = {path: multiplier} if path else {}
        if self._merged_loras == want:
            return
        if self._params_quantized():
            runtime, leftover = (load_runtime_lora(list(want.items()),
                                                   pipe.dit.cfg)
                                 if want else (None, {}))
            if leftover:
                print(f"[controller] runtime LoRA over fp8: skipping "
                      f"{len(leftover)} non-block module(s): "
                      f"{sorted(leftover)[:4]}...", flush=True)
            pipe.set_runtime_lora(runtime)
            self._merged_loras.clear()
            self._merged_loras.update(want)
            return
        dits = pipe._dits()
        for p, m in list(self._merged_loras.items()):
            if want.get(p) != m:
                for dit in dits:
                    unmerge_lora(dit, p, m)
                del self._merged_loras[p]
        for p, m in want.items():
            if p not in self._merged_loras:
                for dit in dits:
                    merge_lora(dit, p, m)
                self._merged_loras[p] = m

    # ---------------------------------------------------------- weight swap
    def update_diffusion_transformer(self, path: Optional[str]) -> None:
        """Swap the DiT weights for a checkpoint's (the reference's
        model-switch endpoint, `videox_fun/api/api.py:23-39`); ``'none'``
        or empty is a no-op. The checkpoint must match the resident
        architecture. A Wan2.2 dual-expert directory (``low_noise_model/``
        and ``high_noise_model/``) swaps both experts of a MoE pipeline; a
        single-expert path swaps the base expert, after unmerging fused
        LoRA files so the other expert is left pristine. Runtime adapters
        are detached and the LoRA tracker cleared: the new weights are
        plain. A checkpoint of another family (or a Wan one while another
        family is resident) replaces the pipeline
        (`_switch_family_pipeline`)."""
        if not path or path == "none":
            return
        from ..factory import (HIGH_NOISE_SUBPATH, LOW_NOISE_SUBPATH,
                               detect_family, is_wan22_moe_dir)
        target = detect_family(path)
        if target != "wan" or self.family != "wan":
            self._switch_family_pipeline(path, target)
            return
        pipe = self._wan_pipeline()
        dit_2 = getattr(pipe, "dit_2", None)
        if is_wan22_moe_dir(path):
            if dit_2 is None:
                raise RuntimeError(
                    f"{path} is a Wan2.2 dual-expert checkpoint but the "
                    "resident pipeline has no high-noise expert; restart "
                    "with load_pipeline(high_noise_model=...) or point at "
                    "a single-expert checkpoint")
            pairs = [(pipe.dit, os.path.join(path, LOW_NOISE_SUBPATH)),
                     (dit_2, os.path.join(path, HIGH_NOISE_SUBPATH))]
            staged = [(dit, self._staged_state(dit, p)) for dit, p in pairs]
        else:
            staged = [(pipe.dit, self._staged_state(pipe.dit, path))]
            if self._merged_loras and dit_2 is not None:
                self.ensure_lora(None)
        for dit, sd in staged:
            _copy_into(dit, sd)
        pipe.set_runtime_lora(None)
        self._merged_loras.clear()

    def _switch_family_pipeline(self, path: str, target_family: str) -> None:
        """Replace the resident pipeline with one loaded for ``path``'s
        family (Wan too, on the way back). The old pipeline is released
        before the load (its DiTs dropped, the allocator's cache emptied),
        so the card holds one model at a time, as JAX deletes the old
        DiT's buffers first. The new one goes on the old one's device in
        its dtype; Wan is rebuilt with ``wan_load_kwargs``."""
        import gc
        old = self.pipeline
        if (self.family == "wan" and self._params_quantized()
                and "quantize" not in self.wan_load_kwargs):
            self._inferred_quantize = "fp8"
        dtype = getattr(old, "dtype", None) or torch.bfloat16
        device = getattr(old, "device", None)
        for attr in ("dit", "dit_2"):
            if getattr(old, attr, None) is not None:
                setattr(old, attr, None)
        self.pipeline = old = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        if target_family == "wan":
            from ..factory import load_pipeline
            kw = dict(self.wan_load_kwargs)
            if "quantize" not in kw and self._inferred_quantize:
                kw["quantize"] = self._inferred_quantize
            kw.setdefault("device", device)
            self.pipeline = load_pipeline(path, dtype=dtype, **kw)
        else:
            from ..factory import load_family_pipeline
            quantize = self.wan_load_kwargs.get("quantize")
            if (quantize is None and self._inferred_quantize
                    and target_family in ("flux", "qwenimage")):
                quantize = self._inferred_quantize
                print(f"[controller] applying inferred quantize="
                      f"{quantize!r} to {target_family} load (no explicit "
                      f"--quantize)", flush=True)
            self.pipeline = load_family_pipeline(
                path, dtype=dtype, family=target_family, quantize=quantize,
                device=device)
        self.model_name = path
        self._merged_loras.clear()
        self._cfg_seq_default = None

    def _staged_state(self, dit, path: str) -> Dict[str, torch.Tensor]:
        """The checkpoint at ``path`` as ``dit``'s state dict, still on the
        host (mapped files), every name and shape checked against ``dit``
        before any tensor is copied: a wrong checkpoint raises and leaves
        the resident weights as they were."""
        from ..models import weights
        sd = weights.convert_dit_state_dict(weights.load_state_dict(path),
                                            dit.cfg, self.pipeline.dtype)
        resident = {k: v for k, v in dit.state_dict().items()
                    if not k.endswith(".weight_scale")}
        if set(sd) != set(resident):
            raise ValueError(
                f"{path} does not hold the resident DiT's tensors: missing "
                f"{sorted(set(resident) - set(sd))[:4]}, extra "
                f"{sorted(set(sd) - set(resident))[:4]}")
        bad = [k for k, v in sd.items() if v.shape != resident[k].shape]
        if bad:
            raise ValueError(
                f"{path} does not match the resident architecture: "
                + ", ".join(f"{k} {tuple(sd[k].shape)} vs "
                            f"{tuple(resident[k].shape)}" for k in bad[:4]))
        return sd

    def _apply_cfg_sequential(self, gen_kwargs: Dict[str, Any]) -> None:
        """The request's sequential-CFG knob (a pipeline attribute, not a
        call argument; generations are serialized, so setting it here is
        race-free), or the pipeline's own value when the request omits
        it."""
        if self._cfg_seq_default is None:
            self._cfg_seq_default = bool(
                getattr(self.pipeline, "cfg_sequential", False))
        self.pipeline.cfg_sequential = bool(
            gen_kwargs.pop("cfg_sequential", self._cfg_seq_default))

    def _resolve_teacache_coefficients(self,
                                       gen_kwargs: Dict[str, Any]) -> None:
        """The checkpoint name's TeaCache coefficients (its alias), unless
        the request gives its own."""
        if (gen_kwargs.get("enable_teacache") and self.model_name and
                "teacache_coefficients" not in gen_kwargs):
            from ..models.teacache import get_teacache_coefficients
            coeffs = get_teacache_coefficients(self.model_name)
            if coeffs is not None:
                gen_kwargs["teacache_coefficients"] = coeffs

    # ------------------------------------------------------------- generate
    def generate(
        self,
        video_path: Optional[str] = None,
        video_array: Optional[np.ndarray] = None,
        prompt: str = "",
        raw_prompt: bool = False,
        source_frames: Optional[int] = None,
        reasoning_frames: Optional[int] = None,
        num_inference_steps: Optional[int] = None,
        guidance_scale: Optional[float] = None,
        seed: Optional[int] = None,
        sampler: Optional[str] = None,
        shift: Optional[float] = None,
        negative_prompt: Optional[str] = None,
        **gen_kwargs,
    ) -> Dict[str, Any]:
        """One chain-of-frames edit of ``video_array`` (or the clip at
        ``video_path``, stride-sampled) per ``prompt`` (turned into the CoT
        prompt unless ``raw_prompt``); unset knobs take ``defaults``, and
        ``gen_kwargs`` reach the pipeline."""
        d = self.defaults
        source_frames = source_frames or d.source_frames
        if video_array is None:
            if not video_path:
                raise ValueError("provide video_path or video_array")
            video_array, _, _ = load_video_frames(
                video_path, source_frames,
                rng=np.random.default_rng(seed or d.seed))
        full_prompt = prompt if raw_prompt else build_cot_prompt(prompt)
        self._apply_cfg_sequential(gen_kwargs)
        self._resolve_teacache_coefficients(gen_kwargs)
        out = self.pipeline(
            video_array, full_prompt,
            negative_prompt=(negative_prompt if negative_prompt is not None
                             else d.negative_prompt),
            source_frames=source_frames,
            reasoning_frames=(reasoning_frames or d.reasoning_frames),
            num_inference_steps=(num_inference_steps or
                                 d.num_inference_steps),
            guidance_scale=(guidance_scale if guidance_scale is not None
                            else d.guidance_scale),
            shift=(shift or d.shift),
            sampler=(sampler or d.sampler),
            repeat_rope=d.repeat_rope, cot=d.cot,
            seed=(seed if seed is not None else d.seed),
            **gen_kwargs,
        )
        return {"prompt": full_prompt, "videos": out.videos,
                "ground_videos": out.ground_videos,
                "edit_videos": out.edit_videos}

    def generate_t2v(
        self,
        prompt: str = "",
        height: int = 480,
        width: int = 832,
        num_frames: int = 81,
        num_inference_steps: Optional[int] = None,
        guidance_scale: Optional[float] = None,
        seed: Optional[int] = None,
        sampler: Optional[str] = None,
        shift: Optional[float] = None,
        negative_prompt: Optional[str] = None,
        **gen_kwargs,
    ) -> Dict[str, Any]:
        """Text-to-video (`pipeline.text_to_video`, the reference's
        Wan2_2Pipeline flow) with the prompt used raw: the CoT phrasing
        belongs to editing."""
        d = self.defaults
        self._apply_cfg_sequential(gen_kwargs)
        self._resolve_teacache_coefficients(gen_kwargs)
        out = self.pipeline.text_to_video(
            prompt,
            height=height, width=width, num_frames=num_frames,
            negative_prompt=(negative_prompt if negative_prompt is not None
                             else d.negative_prompt),
            num_inference_steps=(num_inference_steps or
                                 d.num_inference_steps),
            guidance_scale=(guidance_scale if guidance_scale is not None
                            else d.guidance_scale),
            shift=(shift or d.shift),
            sampler=(sampler or d.sampler),
            seed=(seed if seed is not None else d.seed),
            **gen_kwargs,
        )
        return {"prompt": prompt, "videos": out.videos,
                "ground_videos": None, "edit_videos": out.edit_videos}

    def generate_media(
        self,
        text_embeddings: np.ndarray,
        negative_embeddings: Optional[np.ndarray] = None,
        pooled_projections: Optional[np.ndarray] = None,
        num_inference_steps: Optional[int] = None,
        guidance_scale: Optional[float] = None,
        seed: Optional[int] = None,
        **gen_kwargs,
    ) -> Dict[str, Any]:
        """Generation of the CogVideoX, Flux and QwenImage pipelines from
        precomputed text embeddings (their encoders are out of scope, as
        in JAX): {'videos': [B, 3, F, H, W]} for CogVideoX, {'images': [B,
        3, H, W] or latents} for the image families. Unset knobs: the
        defaults' steps and seed, guidance 6 (CogVideoX), true CFG 4
        (QwenImage) or guidance 3.5 (Flux, whose pooled projections are
        zeros when not given). On a Wan pipeline it raises, as JAX's."""
        fam = self.family
        if fam == "wan":
            raise RuntimeError(
                "generate_media serves the CogVideoX/Flux/QwenImage "
                "families; this controller holds a Wan pipeline — use "
                "generate/generate_t2v")
        d = self.defaults
        steps = num_inference_steps or d.num_inference_steps
        seed = seed if seed is not None else d.seed
        if fam == "cogvideox":
            videos = self.pipeline(
                text_embeddings, negative_embeddings,
                num_inference_steps=steps,
                guidance_scale=(guidance_scale
                                if guidance_scale is not None else 6.0),
                seed=seed, **gen_kwargs)
            return {"videos": videos, "images": None}
        if fam == "qwenimage":
            images = self.pipeline(
                text_embeddings, negative_embeddings,
                num_inference_steps=steps,
                true_cfg_scale=(guidance_scale
                                if guidance_scale is not None else 4.0),
                seed=seed, **gen_kwargs)
            return {"videos": None, "images": images}
        if pooled_projections is None:
            pooled_projections = np.zeros(
                (np.asarray(text_embeddings).shape[0],
                 self.pipeline.dit_cfg.pooled_projection_dim), np.float32)
        images = self.pipeline(
            text_embeddings, pooled_projections, num_inference_steps=steps,
            guidance=(guidance_scale if guidance_scale is not None else 3.5),
            seed=seed, **gen_kwargs)
        return {"videos": None, "images": images}

    # --------------------------------------------------------------- encode
    @staticmethod
    def encode_image_base64(image: np.ndarray) -> str:
        """PNG bytes as base64 of one decoded image ([3, H, W], or the first
        of [B, 3, H, W], float in [0, 1]): the image families' reply."""
        from PIL import Image
        arr = np.asarray(image, np.float32)
        if arr.ndim == 4:
            arr = arr[0]
        arr = np.clip(arr, 0.0, 1.0)
        arr = (arr * 255.0).round().astype(np.uint8).transpose(1, 2, 0)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()

    @staticmethod
    def encode_array_base64(arr: np.ndarray) -> str:
        """.npy bytes as base64."""
        buf = io.BytesIO()
        np.save(buf, np.asarray(arr), allow_pickle=False)
        return base64.b64encode(buf.getvalue()).decode()

    @staticmethod
    def encode_video_base64(video: np.ndarray, fps: int = 16) -> str:
        """mp4 bytes as base64 (the reference API's transport,
        `videox_fun/api/api.py:90-226`) of ``video`` [B, C, T, H, W] or
        [C, T, H, W] in [0, 1]."""
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "out.mp4")
            save_video(video, path, fps=fps)
            if not os.path.exists(path):
                # save_video wrote its PNG-sequence fallback: no mp4 writer
                raise RuntimeError("no mp4 encoder available on this host "
                                   "(cv2 lacks an mp4 codec)")
            with open(path, "rb") as f:
                return base64.b64encode(f.read()).decode()


@torch.no_grad()
def _copy_into(dit, sd: Dict[str, torch.Tensor]) -> None:
    """Copy the staged (host) state ``sd`` into ``dit``'s tensors in place,
    one tensor at a time; an fp8 weight is quantized on its device on the
    way in (`quantize_weight`, as `quantize_dit_fp8` does), with its
    scale."""
    from ..utils.fp8 import FP8, quantize_weight
    resident = dit.state_dict()
    for name, src in sd.items():
        dst = resident[name]
        if dst.dtype == FP8:
            q, scale = quantize_weight(src.to(dst.device))
            dst.copy_(q)
            resident[name + "_scale"].copy_(scale)
        else:
            dst.copy_(src)


@dataclass
class VideoCoFClient:
    """Client of a remote `serving.api` host, the twin of the reference's
    `Fun_Controller_Client.post_to_host`
    (`videox_fun/ui/controller.py:345-513`): stdlib only (urllib), the
    token in the Authorization header as the reference's EAS_TOKEN."""

    url: str                       # e.g. "http://host:8188"
    token: Optional[str] = None
    timeout: float = 300.0

    def post_to_host(self, prompt: str,
                     video_path: Optional[str] = None,
                     video_b64: Optional[str] = None,
                     save_path: Optional[str] = None,
                     **params) -> Dict[str, Any]:
        """POST one edit. ``params`` are sent under the reference's field
        names (seed_textbox, sample_step_slider, cfg_scale_slider,
        source_frames, reasoning_frames). Returns the reply with the mp4's
        bytes under ``video_bytes``, also written to ``save_path``."""
        import urllib.request
        if video_b64 is None:
            if not video_path:
                raise ValueError("provide video_path or video_b64")
            with open(video_path, "rb") as f:
                video_b64 = base64.b64encode(f.read()).decode()
        payload = {"prompt_textbox": prompt, "source_video": video_b64}
        payload.update(params)
        from .api import ENDPOINT
        req = urllib.request.Request(
            self.url.rstrip("/") + ENDPOINT,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json",
                     **({"Authorization": self.token} if self.token else {})},
            method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            out = json.loads(resp.read())
        if out.get("base64_encoding"):
            out["video_bytes"] = base64.b64decode(out["base64_encoding"])
            if save_path:
                os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
                with open(save_path, "wb") as f:
                    f.write(out["video_bytes"])
        elif save_path:
            # the caller asked for a file: fail rather than return an error
            # reply they may never read
            raise RuntimeError(f"server returned no video: "
                               f"{out.get('message', out)}")
        return out
