"""Chain-of-frames triplet dataset (training side); a copy of
`videocof_tpu/data/dataset.py`, which the port does not import.

Behavioural rebuild of the reference `ImageVideoCoTDataset`
(`dataset_image_video.py:1161-1650`), the VideoCoF-50k loader: JSON items
``{original_video, grounded_video, edited_video, edit_instruction}``;
``source_frames`` source indices sampled by linspace, grounding frames taken
from the grounded video at the first ``reasoning_frames`` source indices,
edited frames at the same source indices; all three streams resize+center-crop
aligned; the CoT prompt built from the instruction (with the derived grounding
phrase) and a 10% text drop; infinite-retry ``__getitem__`` that resamples a
random index on error.

Framework-free: returns numpy dicts; wrap in any loader. The pixel layout
[src | ground | tgt] matches the pipeline's CoT latent layout.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from .buckets import resize_center_crop
from .instructions import build_cot_prompt


# ------------------------------------------------------- grounding-frame modes

def interpolate_ground_frames(ground_first: np.ndarray,
                              target_first: np.ndarray,
                              total_steps: int = 16,
                              pick_indices=(0, 3, 6, 9, 12)) -> np.ndarray:
    """Gradual-interpolation grounding mode: blend linearly from the grounded
    video's first frame to the edited video's first frame over
    ``total_steps`` (align_corners semantics: weight i/(T-1)) and pick
    ``pick_indices`` (reference `_interpolate_ground_frames`,
    `dataset_image_video.py:1312-1343`, called with picks (0,3,6,9,12) at
    `:1489-1494`). uint8 [len(picks), H, W, 3]."""
    if ground_first.shape[:2] != target_first.shape[:2]:
        import cv2
        target_first = cv2.resize(
            target_first, (ground_first.shape[1], ground_first.shape[0]),
            interpolation=cv2.INTER_LINEAR)
    a = ground_first.astype(np.float32) / 255.0
    b = target_first.astype(np.float32) / 255.0
    out = []
    for idx in pick_indices:
        i = max(0, min(int(idx), total_steps - 1))
        w = i / float(total_steps - 1)
        out.append(np.clip((1.0 - w) * a + w * b, 0.0, 1.0))
    return (np.stack(out) * 255.0).astype(np.uint8)


def build_gray_mask(frame: np.ndarray, intensity_range=(96, 160),
                    tolerance: int = 12) -> np.ndarray:
    """Boolean [H, W] mask of 'gray' pixels: near-equal channels within an
    intensity band (reference `_build_gray_mask`,
    `dataset_image_video.py:1346-1358`; defaults `:1187-1188`)."""
    f = frame.astype(np.float32)
    if f.max() <= 1.0:
        f = f * 255.0
    cmax, cmin = f.max(axis=2), f.min(axis=2)
    mask = (cmax - cmin) <= float(tolerance)
    mask &= cmax >= float(intensity_range[0])
    mask &= cmax <= float(intensity_range[1])
    return mask


def apply_gray_region_effect(frames: np.ndarray, mode: str,
                             intensity_range=(96, 160),
                             tolerance: int = 12) -> np.ndarray:
    """'red': paint gray regions red; 'black': black background, keep only
    the gray regions (reference `_apply_gray_region_effect`,
    `dataset_image_video.py:1360-1379`)."""
    out = []
    for frame in frames:
        mask = build_gray_mask(frame, intensity_range, tolerance)
        if not mask.any():
            out.append(frame)
            continue
        fo = frame.copy()
        red = (np.array([1.0, 0, 0], fo.dtype)
               if np.issubdtype(fo.dtype, np.floating) and fo.max() <= 1.0
               else np.array([255, 0, 0], fo.dtype))
        if mode == "red":
            fo[mask] = red
        else:
            fo[:] = 0
            fo[mask] = frame[mask]
        out.append(fo)
    return np.stack(out)


def apply_gray_overlay(src_frames: np.ndarray, ref_frames: np.ndarray,
                       alpha: float = 0.5, gray_value: float = 0.5,
                       num_frames: int = 4, intensity_range=(96, 160),
                       tolerance: int = 12) -> np.ndarray:
    """Alpha-blend 50% gray onto the first ``num_frames`` source frames at
    the gray regions detected on the reference (grounding) frames
    (reference `_apply_gray_overlay_from_reference`,
    `dataset_image_video.py:1380-1415`)."""
    n = min(int(num_frames), len(src_frames), len(ref_frames))
    out = src_frames.copy()
    a = float(np.clip(alpha, 0.0, 1.0))
    gv = float(np.clip(gray_value, 0.0, 1.0))
    for i in range(n):
        mask = build_gray_mask(ref_frames[i], intensity_range, tolerance)
        if not mask.any():
            continue
        src = out[i]
        to_u8 = not np.issubdtype(src.dtype, np.floating)
        f = src.astype(np.float32) / (255.0 if to_u8 or src.max() > 1.0
                                      else 1.0)
        f[mask] = (1.0 - a) * f[mask] + a * gv
        out[i] = ((f * 255.0).clip(0, 255).astype(src.dtype) if to_u8
                  else f.astype(src.dtype))
    return out


def _read_frames_at(path: str, indices: List[int]) -> np.ndarray:
    import cv2
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(path)
    frames = []
    for idx in indices:
        cap.set(cv2.CAP_PROP_POS_FRAMES, int(idx))
        ok, frame = cap.read()
        if not ok:
            raise ValueError(f"decode failed at frame {idx} of {path}")
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    return np.stack(frames)


def _frame_count(path: str) -> int:
    import cv2
    cap = cv2.VideoCapture(path)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return n


class CoTTripletDataset:
    def __init__(
        self,
        json_path: str,
        data_root: Optional[str] = None,
        height: int = 480,
        width: int = 832,
        source_frames: int = 33,
        target_frames: int = 33,
        reasoning_frames: int = 4,
        text_drop_ratio: float = 0.1,
        seed: int = 0,
        max_retries: int = 100,
        gradual_ground: bool = False,
        gray_viz: Optional[str] = None,
        gray_intensity_range=(96, 160),
        gray_tolerance: int = 12,
        gray_alpha: float = 0.5,
    ):
        """``gradual_ground``: grounding frames blend from the grounded
        video's first frame to the edited first frame instead of being read
        from the grounded video (reference `enable_gradual_ground`).
        ``gray_viz`` in {None, "red", "black", "overlay"}: gray-region
        visualization of the grounding frames (mutually exclusive modes,
        reference `:1254-1256`)."""
        with open(json_path, encoding="utf-8") as f:
            self.items = json.load(f)
        self.data_root = data_root
        self.height, self.width = height, width
        self.source_frames = source_frames
        self.target_frames = target_frames
        self.reasoning_frames = reasoning_frames
        self.text_drop_ratio = text_drop_ratio
        self.rng = np.random.default_rng(seed)
        self.max_retries = max_retries
        if gray_viz not in (None, "red", "black", "overlay"):
            raise ValueError(f"gray_viz {gray_viz!r} not in "
                             "(None, 'red', 'black', 'overlay')")
        self.gradual_ground = gradual_ground
        self.gray_viz = gray_viz
        self.gray_intensity_range = tuple(gray_intensity_range)
        self.gray_tolerance = int(gray_tolerance)
        self.gray_alpha = float(gray_alpha)

    def __len__(self) -> int:
        return len(self.items)

    def _path(self, p: str) -> str:
        return os.path.join(self.data_root, p) if self.data_root else p

    def _load_one(self, idx: int) -> Dict[str, np.ndarray]:
        item = self.items[idx]
        src_path = self._path(item.get("original_video",
                                       item.get("source_video_path", "")))
        grd_path = self._path(item.get("grounded_video", src_path))
        edt_path = self._path(item.get("edited_video", src_path))
        instruction = item.get("edit_instruction", item.get("text", ""))

        total = _frame_count(src_path)
        if total < 1:
            raise ValueError(f"empty video {src_path}")
        src_idx = np.linspace(0, total - 1, self.source_frames).astype(int)
        tgt_total = _frame_count(edt_path)
        tgt_idx = np.linspace(0, tgt_total - 1, self.target_frames).astype(int)

        def read(path, indices):
            arr = _read_frames_at(path, list(indices))
            return resize_center_crop(arr, self.height, self.width)  # uint8

        src_u8 = read(src_path, src_idx)
        tgt_u8 = read(edt_path, tgt_idx)

        if self.gradual_ground:
            grd_first = read(grd_path, [0])[0]
            grd_u8 = interpolate_ground_frames(
                grd_first, tgt_u8[0], total_steps=16,
                pick_indices=tuple(range(0, 3 * self.reasoning_frames, 3)))
        else:
            # grounding frames: grounded video at the first source indices
            grd_total = _frame_count(grd_path)
            grd_idx = np.clip(src_idx[: self.reasoning_frames], 0,
                              grd_total - 1)
            grd_u8 = read(grd_path, grd_idx)

        if self.gray_viz in ("red", "black"):
            grd_u8 = apply_gray_region_effect(
                grd_u8, self.gray_viz, self.gray_intensity_range,
                self.gray_tolerance)
        elif self.gray_viz == "overlay":
            grd_u8 = apply_gray_overlay(
                src_u8, grd_u8, alpha=self.gray_alpha, gray_value=0.5,
                num_frames=self.reasoning_frames,
                intensity_range=self.gray_intensity_range,
                tolerance=self.gray_tolerance)

        def norm(arr):
            out = arr.transpose(3, 0, 1, 2).astype(np.float32)
            return out * (2.0 / 255.0) - 1.0          # [C, T, H, W] in [-1,1]

        text = build_cot_prompt(instruction)
        if self.rng.random() < self.text_drop_ratio:
            text = ""

        return {
            "pixel_src": norm(src_u8),
            "pixel_ground": norm(grd_u8),
            "pixel_tgt": norm(tgt_u8),
            "text": text,
            "edit_instruction": instruction,
        }

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        for _ in range(self.max_retries):
            try:
                return self._load_one(idx)
            except Exception:
                idx = int(self.rng.integers(0, len(self.items)))
        raise RuntimeError("dataset: too many consecutive load failures")

    def cot_pixels(self, sample: Dict[str, np.ndarray]) -> np.ndarray:
        """[src | ground | tgt] concat along time — the training-side pixel
        analogue of the CoT latent layout."""
        return np.concatenate([sample["pixel_src"], sample["pixel_ground"],
                               sample["pixel_tgt"]], axis=1)
