"""Shared CLI machinery of the inference entry points.

Counterpart of `videocof_tpu/cli/_common.py` for the chain-of-frames edit
(the reference's `fast_infer.py:214-456`): task-JSON or single-video mode,
resume by skipping finished outputs, items strided over processes
(``pending[rank::world]``), the CoT prompt, and the reason+edit, edit-only
and side-by-side outputs with an ``_info.txt`` prompt record; ``--t2v``
items (text-to-video, with ``--guidance_scale_2`` on a Wan2.2 MoE),
``--start_image`` items (image-to-video on an i2v checkpoint, its CLIP
tower encoding the start image) and ``--control_video`` items (VACE
control-to-video on a VACE checkpoint) write the video and its prompt
record. ``--quantize fp8`` and ``--offload_t5`` reach the factory, which
also finds Wan2.2 MoE, Wan2.2-VAE, i2v and VACE directories. Every flag of
the JAX CLI parses, so the reference's scripts do; ahead-of-time
compilation, which the port does not carry, stops with an error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.instructions import build_cot_prompt
from ..utils.video_io import (load_video_frames, save_results,
                              save_side_by_side)

# flag -> why it stops
_UNPORTED_FLAGS = {
    "precompile_hw": "the JAX package's ahead-of-time fused sampler (not "
                     "ported on purpose: the port runs the sampler stepwise)",
}
# --attention: the port's backends, and JAX's names for them
ATTENTION_BACKENDS = {None: None, "flash": "flash", "int8": "int8",
                      "naive": "naive", "pallas": "flash"}


def add_common_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--test_json", type=str, default=None,
                        help="Path to test JSON for batch inference")
    parser.add_argument("--prompt", type=str, default=None)
    parser.add_argument("--video_path", type=str, default=None)
    parser.add_argument("--model_name", type=str, default=None,
                        help="Checkpoint dir (omit with --random_init)")
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--videocof_path", type=str, default=None,
                        help="VideoCoF LoRA checkpoint")
    parser.add_argument("--lora_path", type=str, default=None)
    parser.add_argument("--lora_weight", type=float, default=1.0)
    parser.add_argument("--num_frames", type=int, default=65)
    parser.add_argument("--source_frames", type=int, default=33)
    parser.add_argument("--reasoning_frames", type=int, default=4)
    parser.add_argument("--repeat_rope", action="store_true")
    parser.add_argument("--sampler", type=str, default="unipc",
                        choices=["unipc", "euler", "dpm++"])
    parser.add_argument("--shift", type=float, default=3.0)
    parser.add_argument("--solver_order", type=int, default=None,
                        choices=(1, 2, 3),
                        help="UniPC/DPM++ multistep order (default 2)")
    parser.add_argument("--start_image", type=str, default=None,
                        help="image-to-video from this image and --prompt "
                             "(needs an i2v checkpoint with its CLIP tower)")
    parser.add_argument("--end_image", type=str, default=None,
                        help="last-frame pin of --start_image")
    parser.add_argument("--t2v", action="store_true",
                        help="text-to-video from --prompt")
    parser.add_argument("--control_video", type=str, default=None,
                        help="VACE control-to-video: generate --prompt under "
                             "this control clip (needs a VACE checkpoint)")
    parser.add_argument("--control_mask", type=str, default=None,
                        help="region-mask clip of --control_video (bright = "
                             "generate; omitted: full generation)")
    parser.add_argument("--vace_scale", type=float, default=1.0,
                        help="control-hint strength (context_scale)")
    parser.add_argument("--cfg_sequential", action="store_true",
                        help="run CFG as two batch-1 forwards instead of "
                             "one batch-2 forward (half the activations)")
    parser.add_argument("--height", type=int, default=480)
    parser.add_argument("--width", type=int, default=832)
    parser.add_argument("--guidance_scale_2", type=float, default=None,
                        help="high-noise-expert guidance of a Wan2.2 MoE "
                             "(--t2v)")
    parser.add_argument("--fps", type=int, default=10)
    parser.add_argument("--random_init", action="store_true",
                        help="Random weights (weight-free runs)")
    parser.add_argument("--attention", type=str, default=None,
                        choices=[None, "flash", "int8", "naive", "pallas",
                                 "xla"],
                        help="flash (the default; JAX's 'pallas' names it "
                             "too), int8 or naive; 'xla' stops: the port "
                             "has no library attention backend")
    parser.add_argument("--quantize", type=str, default=None,
                        choices=[None, "fp8"],
                        help="fp8 weight storage of the DiT(s)")
    parser.add_argument("--offload_t5", action="store_true",
                        help="host-resident umT5, shipped to the device "
                             "for each prompt encoding")
    parser.add_argument("--precompile_hw", type=int, nargs=2, default=None,
                        metavar=("H", "W"),
                        help="ahead-of-time fused sampler (not ported)")


def check_ported(args) -> None:
    """Stop, naming the ROADMAP.md item, on a mode the port does not carry."""
    for flag, what in _UNPORTED_FLAGS.items():
        if getattr(args, flag, None):
            raise SystemExit(f"--{flag}: {what} is not ported to "
                             f"videocof_torch")
    if args.attention == "xla":
        raise SystemExit("--attention xla: the port has no library attention "
                         "backend; use flash (JAX's pallas), int8 or naive")


def collect_items(args) -> List[Tuple[str, Dict]]:
    if args.test_json:
        with open(args.test_json, encoding="utf-8") as f:
            entries = json.load(f)
        items = []
        for i, item in enumerate(entries):
            if "task_type" in item and "sample_id" in item:
                fname = f"{item['task_type']}_{item['sample_id']}.mp4"
            else:
                fname = f"sample_{i}.mp4"
            items.append((fname, item))
        return items
    if args.video_path and args.prompt:
        return [(os.path.basename(args.video_path),
                 {"source_video_path": args.video_path,
                  "edit_instruction": args.prompt})]
    if getattr(args, "start_image", None) and args.prompt:
        return [(os.path.basename(args.start_image),
                 {"start_image_path": args.start_image,
                  "end_image_path": getattr(args, "end_image", None),
                  "edit_instruction": args.prompt})]
    if getattr(args, "control_video", None) and args.prompt:
        return [(os.path.basename(args.control_video),
                 {"control_video_path": args.control_video,
                  "control_mask_path": getattr(args, "control_mask", None),
                  "edit_instruction": args.prompt})]
    if getattr(args, "t2v", False) and args.prompt:
        slug = "".join(c if c.isalnum() else "_"
                       for c in args.prompt.lower())[:48] or "t2v"
        return [(f"{slug}.mp4", {"t2v": True,
                                 "edit_instruction": args.prompt})]
    raise SystemExit("provide --test_json, --video_path/--start_image/"
                     "--control_video plus --prompt, or --t2v --prompt")


def process_rank() -> Tuple[int, int]:
    """(rank, world): from `torch.distributed` when it is initialised, else
    the ``RANK`` and ``WORLD_SIZE`` variables, else (0, 1)."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    return (int(os.environ.get("RANK", 0)),
            int(os.environ.get("WORLD_SIZE", 1)))


def shard_pending(items, output_dir: str):
    """Resume + sharding: drop finished outputs, stride over processes."""
    pending = [(fname, item) for fname, item in items
               if not os.path.exists(os.path.join(
                   output_dir, f"gen_{os.path.splitext(fname)[0]}.mp4"))]
    rank, world = process_rank()
    return pending[rank::world], rank, world


def item_prompt(item: Dict) -> Tuple[str, str]:
    edit_text = item.get("text", item.get("qwen_vl_72b_refined_instruction",
                                          item.get("edit_instruction", "")))
    return build_cot_prompt(edit_text), edit_text


def edit_frames(pipe, args, video: np.ndarray, prompt: str, rank: int, *,
                num_inference_steps: int, guidance_scale: float,
                negative_prompt: str, gen_kwargs: Optional[Dict] = None
                ) -> Dict[str, np.ndarray]:
    """One item's edit from its decoded frames (uint8 [1, 3, T, H, W] or
    I420 planes [1, T, H*3//2, W]), with ``gen_kwargs`` passed on to the
    pipeline (TeaCache, cfg-skip) -> the arrays the item's files hold:
    ``reason_edit`` (ground and edit frames), ``edit`` (the last
    ``source_frames``) and ``source`` (the input in [0, 1], for the
    side-by-side), each [1, 3, T, H, W] float in [0, 1]."""
    out = pipe(video, prompt, negative_prompt=negative_prompt,
               source_frames=args.source_frames,
               reasoning_frames=args.reasoning_frames,
               num_inference_steps=num_inference_steps,
               guidance_scale=guidance_scale, shift=args.shift,
               sampler=args.sampler, solver_order=args.solver_order,
               repeat_rope=args.repeat_rope, cot=True,
               seed=args.seed + rank, **(gen_kwargs or {}))
    if video.ndim == 4:          # I420 planes -> RGB for the comparison
        from ..utils.colorspace import i420_to_rgb01
        video = i420_to_rgb01(video)
    return {"reason_edit": out.videos,
            "edit": out.videos[:, :, -args.source_frames:],
            "source": video}


def t2v_frames(pipe, args, item: Dict, prompt: str, rank: int, *,
               num_inference_steps: int, guidance_scale: float,
               negative_prompt: str) -> Dict[str, np.ndarray]:
    """One ``--t2v`` item: the pipeline's `text_to_video` at the flags'
    size and frame count (``--guidance_scale_2`` on a Wan2.2 MoE) -> its
    ``video`` [1, 3, T, H, W] float in [0, 1]."""
    kw = {}
    if (args.guidance_scale_2 is not None
            and getattr(pipe, "dit_2", None) is not None):
        kw["guidance_scale_2"] = args.guidance_scale_2
    out = pipe.text_to_video(
        prompt, height=args.height, width=args.width,
        num_frames=args.num_frames, negative_prompt=negative_prompt,
        num_inference_steps=num_inference_steps,
        guidance_scale=guidance_scale, shift=args.shift,
        sampler=args.sampler, solver_order=args.solver_order,
        seed=args.seed + rank, **kw)
    return {"video": out.videos}


def i2v_frames(pipe, args, item: Dict, prompt: str, rank: int, *,
               num_inference_steps: int, guidance_scale: float,
               negative_prompt: str) -> Dict[str, np.ndarray]:
    """One ``--start_image`` item: `image_to_video` with the pipeline's CLIP
    tower at the image's aspect ratio over the area of the ``--height`` x
    ``--width`` flags, both sides a multiple of 16 -> its ``video``."""
    from PIL import Image
    from ..utils.video_io import size_from_base_resolution
    if getattr(pipe, "clip", None) is None:
        raise SystemExit("--start_image needs an i2v checkpoint with its "
                         "CLIP tower (the factory reads it from the i2v "
                         "directory)")
    with Image.open(item["start_image_path"]) as im:
        w0, h0 = im.size
    base = int(round((args.height * args.width) ** 0.5))
    h0, w0 = size_from_base_resolution(h0, w0, base)
    out = pipe.image_to_video(
        item["start_image_path"], prompt, end_image=item.get("end_image_path"),
        num_frames=args.num_frames, height=(h0 // 16) * 16,
        width=(w0 // 16) * 16, negative_prompt=negative_prompt,
        num_inference_steps=num_inference_steps,
        guidance_scale=guidance_scale, shift=args.shift,
        sampler=args.sampler, solver_order=args.solver_order,
        seed=args.seed + rank, clip=pipe.clip)
    return {"video": out.videos}


def vace_frames(pipe, args, item: Dict, prompt: str, rank: int, *,
                num_inference_steps: int, guidance_scale: float,
                negative_prompt: str) -> Dict[str, np.ndarray]:
    """One ``--control_video`` item: `control_to_video` under the control
    clip's ``--num_frames`` frames and, where given, the mask clip's (the
    same frame indices; bright = generate) -> its ``video``."""
    from ..pipeline import VacePipeline
    if not isinstance(pipe, VacePipeline):
        raise SystemExit("--control_video needs a VACE checkpoint (the "
                         "factory detects vace_* keys in the DiT's)")
    # one fixed generator: the mask clip samples the control clip's frames
    ctrl, _, _ = load_video_frames(item["control_video_path"],
                                   args.num_frames,
                                   rng=np.random.default_rng(0))
    mask = None
    if item.get("control_mask_path"):
        m, _, _ = load_video_frames(item["control_mask_path"],
                                    args.num_frames,
                                    rng=np.random.default_rng(0))
        mask = (m.mean(axis=1, keepdims=True) > 127.5).astype(np.float32)
    out = pipe.control_to_video(
        prompt, ctrl, mask=mask, negative_prompt=negative_prompt,
        num_inference_steps=num_inference_steps,
        guidance_scale=guidance_scale, context_scale=args.vace_scale,
        shift=args.shift, sampler=args.sampler,
        solver_order=args.solver_order, seed=args.seed + rank)
    return {"video": out.videos}


def save_item(output_dir: str, base: str, arrays: Dict[str, np.ndarray],
              prompt: str, fps: int) -> str:
    """Write an item's ``gen_<base>_reason_edit``, ``gen_<base>``,
    ``gen_<base>_compare`` videos and ``gen_<base>_info.txt``; returns the
    path of ``gen_<base>.mp4``."""
    out_path = os.path.join(output_dir, f"gen_{base}.mp4")
    save_results(arrays["reason_edit"], os.path.join(
        output_dir, f"gen_{base}_reason_edit.mp4"), fps)
    save_results(arrays["edit"], out_path, fps)
    save_side_by_side(arrays["source"], arrays["edit"], os.path.join(
        output_dir, f"gen_{base}_compare.mp4"), fps)
    with open(os.path.join(output_dir, f"gen_{base}_info.txt"), "w",
              encoding="utf-8") as f:
        f.write(prompt)
    return out_path


# the items that write one video: the item key that marks each, in the
# order JAX's run_items tries them, and its helper; the rest are
# chain-of-frames edits
_ITEM_MODES = {"t2v": t2v_frames, "control_video_path": vace_frames,
               "start_image_path": i2v_frames}


def run_items(pipe, args, subset, rank: int, *, num_inference_steps: int,
              guidance_scale: float, negative_prompt: str,
              gen_kwargs: Optional[Dict] = None
              ) -> Dict[str, Dict[str, np.ndarray]]:
    """Edit and write every item of ``subset``; returns {file name: the
    arrays written}. ``VIDEOCOF_UPLOAD_YUV420=1`` uploads I420 planes (half
    the bytes; the chroma is upsampled on the device), else uint8 RGB."""
    os.makedirs(args.output_dir, exist_ok=True)
    rng = np.random.default_rng(args.seed + rank)
    use_i420 = os.environ.get("VIDEOCOF_UPLOAD_YUV420") == "1"
    results = {}
    for fname, item in subset:
        base = os.path.splitext(fname)[0]
        mode = next((m for m in _ITEM_MODES if item.get(m)), None)
        if mode is not None:
            prompt = item.get("edit_instruction", "")
            print(f"[proc {rank}] {mode} {fname}: {prompt}", file=sys.stderr)
            arrays = _ITEM_MODES[mode](pipe, args, item, prompt, rank,
                                       num_inference_steps=num_inference_steps,
                                       guidance_scale=guidance_scale,
                                       negative_prompt=negative_prompt)
            out_path = os.path.join(args.output_dir, f"gen_{base}.mp4")
            save_results(arrays["video"], out_path, args.fps)
            with open(os.path.join(args.output_dir, f"gen_{base}_info.txt"),
                      "w", encoding="utf-8") as f:
                f.write(prompt)
            results[fname] = arrays
            print(f"[proc {rank}] wrote {out_path}", file=sys.stderr)
            continue
        prompt, _ = item_prompt(item)
        print(f"[proc {rank}] {fname}: {prompt}", file=sys.stderr)
        video, _, _ = load_video_frames(
            item["source_video_path"], args.source_frames, rng=rng,
            dtype="i420" if use_i420 else "uint8")
        arrays = edit_frames(pipe, args, video, prompt, rank,
                             num_inference_steps=num_inference_steps,
                             guidance_scale=guidance_scale,
                             negative_prompt=negative_prompt,
                             gen_kwargs=gen_kwargs)
        out_path = save_item(args.output_dir, base, arrays, prompt, args.fps)
        results[fname] = arrays
        print(f"[proc {rank}] wrote {out_path}", file=sys.stderr)
    return results


def build_pipeline_from_args(args):
    """The pipeline the flags ask for, on the CUDA device (the factory
    raises without one): a `Wan22Pipeline` for a Wan2.2 MoE directory,
    fp8 weights with ``--quantize fp8``."""
    from ..factory import load_pipeline

    check_ported(args)
    # the JAX CLI's order: the acceleration LoRA, --lora_path, --videocof_path
    loras = []
    for path, mult in ((getattr(args, "acceleration_lora", None), 1.0),
                       (args.lora_path, args.lora_weight),
                       (args.videocof_path, args.lora_weight)):
        if path:
            if os.path.exists(path):
                loras.append((path, mult))
            else:
                print(f"warning: LoRA not found: {path}", file=sys.stderr)
    # the factory merges the LoRA files before it quantizes
    pipe = load_pipeline(args.model_name or "", random_init=args.random_init,
                         attn_backend=ATTENTION_BACKENDS[args.attention],
                         seed=args.seed, quantize=args.quantize,
                         offload_t5=args.offload_t5, lora_paths=loras)
    for path, _ in loras:
        print(f"merged LoRA: {path}", file=sys.stderr)
    if args.cfg_sequential:
        pipe.cfg_sequential = True
    return pipe
