"""ComfyUI nodes for chain-of-frames video editing on the card.

Counterpart of `videocof_tpu/comfyui/comfyui_nodes.py`. ComfyUI's node
contract is structural: a class with ``INPUT_TYPES`` / ``RETURN_TYPES`` /
``FUNCTION`` / ``CATEGORY`` and the named method. IMAGE wires carry float
[T, H, W, C] torch tensors in [0, 1], ComfyUI's own convention; numpy
arrays are taken too.

A loader owns the pipeline (cached: ComfyUI re-runs the nodes whose inputs
changed) and an editor runs one CoF edit, the reference CLI's surface
(`fast_infer.py`, `inference.py`).
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch


def _to_thwc(frames: Any) -> torch.Tensor:
    """IMAGE wire ([T, H, W, 3] float in [0, 1], torch or numpy) -> a float32
    torch tensor."""
    frames = torch.as_tensor(frames).float()
    if frames.dim() != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected [T, H, W, 3] frames, got "
                         f"{tuple(frames.shape)}")
    return frames


def _to_image_wire(video01: np.ndarray) -> torch.Tensor:
    """pipeline output [B, C, T, H, W] float in [0, 1] -> IMAGE wire
    [T, H, W, C] (the first item)."""
    return torch.from_numpy(np.ascontiguousarray(
        video01[0].transpose(1, 2, 3, 0).astype(np.float32)))


class VideoCoFModelLoader:
    """Builds and caches the pipeline on the card (`factory.load_pipeline`;
    quantize='fp8' stores the DiT's weights in fp8)."""

    # one entry: a pipeline's weights can be most of the card, so a new
    # model frees the old one before it is built
    _cache_key: tuple = ()
    _cache_pipe: Any = None

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "model_name": ("STRING", {"default": ""}),
            "quantize": (["none", "fp8"],),
            "random_init": ("BOOLEAN", {"default": False}),
        }}

    RETURN_TYPES = ("VIDEOCOF_PIPE",)
    RETURN_NAMES = ("pipeline",)
    FUNCTION = "load"
    CATEGORY = "VideoCoF"

    def load(self, model_name: str, quantize: str = "none",
             random_init: bool = False):
        cls = type(self)
        key = (model_name, quantize, random_init)
        if cls._cache_key != key or cls._cache_pipe is None:
            cls._cache_pipe = None          # drop the old weights first
            from ..factory import load_pipeline
            cls._cache_pipe = load_pipeline(
                model_name, random_init=random_init,
                quantize=None if quantize == "none" else quantize)
            cls._cache_key = key
        return (cls._cache_pipe,)


class VideoCoFEdit:
    """One chain-of-frames edit: see -> reason -> edit."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "pipeline": ("VIDEOCOF_PIPE",),
            "frames": ("IMAGE",),
            "prompt": ("STRING", {"multiline": True, "default": ""}),
            "steps": ("INT", {"default": 4, "min": 1, "max": 100}),
            "guidance_scale": ("FLOAT", {"default": 1.0, "min": 0.0,
                                         "max": 20.0}),
            "seed": ("INT", {"default": 42}),
            "reasoning_frames": ("INT", {"default": 4, "min": 1, "max": 16}),
        }, "optional": {
            "return_reasoning": ("BOOLEAN", {"default": False}),
        }}

    RETURN_TYPES = ("IMAGE",)
    RETURN_NAMES = ("frames",)
    FUNCTION = "edit"
    CATEGORY = "VideoCoF"

    def edit(self, pipeline, frames, prompt: str, steps: int = 4,
             guidance_scale: float = 1.0, seed: int = 42,
             reasoning_frames: int = 4,
             return_reasoning: bool = False) -> Tuple[torch.Tensor]:
        from ..data.instructions import build_cot_prompt
        thwc = _to_thwc(frames)
        video = thwc.permute(3, 0, 1, 2)[None] * 2.0 - 1.0   # [1, C, T, H, W]
        out = pipeline(
            video, build_cot_prompt(prompt),
            source_frames=thwc.shape[0],
            reasoning_frames=reasoning_frames,
            num_inference_steps=steps, guidance_scale=guidance_scale,
            seed=seed, repeat_rope=True, cot=True)
        result = out.videos if return_reasoning else out.edit_videos
        return (_to_image_wire(result),)


NODE_CLASS_MAPPINGS = {
    "VideoCoFModelLoader": VideoCoFModelLoader,
    "VideoCoFEdit": VideoCoFEdit,
}

NODE_DISPLAY_NAME_MAPPINGS = {
    "VideoCoFModelLoader": "VideoCoF Model Loader",
    "VideoCoFEdit": "VideoCoF Edit (see-reason-edit)",
}
