"""A copy of `videocof_tpu/data/datasets_legacy.py`. Legacy caption-dataset family — behavioural rebuild of the reference's
`videox_fun/data/dataset_video.py` (WebVid10M `:80-156`, VideoDataset
`:158-241`, its 4-mode `get_random_mask` `:24-62`) and
`videox_fun/data/dataset_image.py` (CC15M `:12-66`).

These are the pre-CoF text-video pretraining loaders (WebVid-10M CSV rows /
generic ``{file_path, text}`` JSON lists). The CoF triplet work never uses
them, but they are the t2v trainer's natural data source, so they are kept
live rather than dropped: numpy-native (no torch/decord/albumentations),
reading through the same cv2 frame reader as the rest of `data/`.

Reference semantics preserved exactly:

- frame selection: ``clip_length = min(total, (n-1)*stride + 1)``, a random
  window start, then ``np.linspace(start, start+clip_length-1, n)`` — short
  clips REPEAT frames via linspace rounding instead of erroring (`:115-118``).
- ``enable_bucket`` returns the raw ``[T, H, W, C]`` uint8 frames (resize
  deferred to bucket collation); otherwise shortest-side resize to
  ``sample_size[0]`` + center crop + ``[-1, 1]`` normalize, ``[T, C, H, W]``
  float32 (torchvision ``Resize(int) -> CenterCrop -> Normalize(.5, .5)``).
- ``enable_inpaint`` attaches the legacy 4-mode random mask and
  ``mask_pixel_values = pixels * (1 - mask) - mask`` (`:148-151`).
- ``is_image`` (WebVid10M only) samples one random frame, ``[C, H, W]``.
- decode failures retry with a random resample (`:138-144`; bounded here
  instead of the reference's unbounded ``while True``).
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from .datasets_extra import _RetryDataset, _norm_chw


def _linspace_indices(total: int, n_frames: int, stride: int,
                      rng: np.random.Generator) -> np.ndarray:
    """Reference `:115-118`: random window, linspace over it."""
    clip_length = min(total, (n_frames - 1) * stride + 1)
    start = int(rng.integers(0, total - clip_length + 1))
    return np.linspace(start, start + clip_length - 1, n_frames).astype(int)


def legacy_random_mask(shape: Tuple[int, int, int, int],
                       rng: Optional[np.random.Generator] = None
                       ) -> np.ndarray:
    """The dataset_video.py 4-mode mask (`:24-62`) — distinct from the
    10-mode `masks.get_random_mask` (dataset_image_video.py). (f, c, h, w)
    -> uint8 [f, 1, h, w]."""
    f, c, h, w = shape
    rng = rng or np.random.default_rng()
    mask = np.zeros((f, 1, h, w), np.uint8)
    mode = int(rng.integers(0, 4))

    def rect():
        cx, cy = int(rng.integers(0, w)), int(rng.integers(0, h))
        bx = int(rng.integers(w // 4, w // 4 * 3))
        by = int(rng.integers(h // 4, h // 4 * 3))
        return (max(cy - by // 2, 0), min(cy + by // 2, h),
                max(cx - bx // 2, 0), min(cx + bx // 2, w))

    if mode == 0:        # everything after the first frame
        mask[1:] = 1
    elif mode == 1:      # interior frames (1:-1)
        mask[1:-1] = 1
    elif mode == 2:      # static rectangle
        y0, y1, x0, x1 = rect()
        mask[:, :, y0:y1, x0:x1] = 1
    else:                # rectangle over a random frame band
        y0, y1, x0, x1 = rect()
        f0 = int(rng.integers(0, f // 2))
        f1 = int(rng.integers(f // 2, f))
        mask[f0:f1, :, y0:y1, x0:x1] = 1
    return mask


def _resize_shortest_center_crop(frames: np.ndarray,
                                 size: Tuple[int, int]) -> np.ndarray:
    """torchvision ``Resize(size[0]) -> CenterCrop(size)`` on uint8
    [T, H, W, C] frames (bilinear; zero-pad when the crop outgrows the
    resized frame, like torchvision's CenterCrop)."""
    import cv2
    t, h, w, c = frames.shape
    scale = size[0] / min(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    out = np.zeros((t, size[0], size[1], c), frames.dtype)
    y0 = (nh - size[0]) // 2
    x0 = (nw - size[1]) // 2
    sy, sx = max(y0, 0), max(x0, 0)
    dy, dx = max(-y0, 0), max(-x0, 0)
    ch = min(size[0] - dy, nh - sy)
    cw = min(size[1] - dx, nw - sx)
    for i in range(t):
        r = cv2.resize(frames[i], (nw, nh), interpolation=cv2.INTER_LINEAR)
        out[i, dy:dy + ch, dx:dx + cw] = r[sy:sy + ch, sx:sx + cw]
    return out


class _LegacyVideoDataset(_RetryDataset):
    """Shared WebVid10M / VideoDataset body; subclasses load annotations
    and resolve item -> (path, caption)."""

    def __init__(self, items, video_folder: Optional[str],
                 sample_size=256, sample_stride: int = 4,
                 sample_n_frames: int = 16, enable_bucket: bool = False,
                 enable_inpaint: bool = False, is_image: bool = False,
                 seed: int = 0, max_retries: int = 100):
        self.items = items
        self.data_root = video_folder or ""
        ss = sample_size
        self.sample_size = (ss, ss) if isinstance(ss, int) else tuple(ss)
        self.sample_stride = sample_stride
        self.sample_n_frames = sample_n_frames
        self.enable_bucket = enable_bucket
        self.enable_inpaint = enable_inpaint
        self.is_image = is_image
        self.rng = np.random.default_rng(seed)
        self.max_retries = max_retries

    def _item_path_text(self, item: dict) -> Tuple[str, str]:
        raise NotImplementedError

    def _load_one(self, idx: int) -> Dict[str, np.ndarray]:
        from .dataset import _frame_count, _read_frames_at
        path, text = self._item_path_text(self.items[idx])
        total = _frame_count(path)
        if total <= 0:
            raise ValueError(f"empty clip {path}")
        if self.is_image:
            indices = np.asarray([int(self.rng.integers(0, total))])
        else:
            indices = _linspace_indices(
                total, self.sample_n_frames, self.sample_stride, self.rng)
        frames = _read_frames_at(path, list(indices))    # [T, H, W, C] u8

        if self.enable_bucket:
            pix = frames if not self.is_image else frames[0]
            return {"pixel_values": pix, "text": text, "idx": idx}

        frames = _resize_shortest_center_crop(frames, self.sample_size)
        # [T, C, H, W] float32 in [-1, 1] (reference layout for this family;
        # _norm_chw gives [C, T, H, W])
        pix = np.moveaxis(_norm_chw(frames), 0, 1)
        sample: Dict[str, np.ndarray] = {"text": text, "idx": idx}
        if self.enable_inpaint and not self.is_image:
            mask = legacy_random_mask(pix.shape, self.rng)
            m = mask.astype(np.float32)
            sample["mask"] = mask
            sample["mask_pixel_values"] = pix * (1.0 - m) - m
        sample["pixel_values"] = pix[0] if self.is_image else pix
        return sample


class WebVid10M(_LegacyVideoDataset):
    """WebVid-10M CSV loader (`dataset_video.py:80-156`): rows with
    ``videoid``/``name``/``page_dir``, clips at
    ``{video_folder}/{videoid}.mp4``."""

    def __init__(self, csv_path: str, video_folder: str, **kw):
        with open(csv_path, encoding="utf-8") as f:
            items = list(csv.DictReader(f))
        super().__init__(items, video_folder, **kw)

    def _item_path_text(self, item: dict) -> Tuple[str, str]:
        return (os.path.join(self.data_root, f"{item['videoid']}.mp4"),
                item.get("name", ""))


class CC15M(_RetryDataset):
    """Legacy caption-image loader — behavioural rebuild of the reference's
    `videox_fun/data/dataset_image.py:12-66` (the t2v trainer's
    image-pretraining source): a JSON list of ``{file_path, text}`` items,
    ``video_folder`` optionally prefixing relative paths.

    - ``enable_bucket=False``: torchvision ``Resize(resolution[0])``
      shortest-side + ``CenterCrop(resolution)`` + ``[-1, 1]`` normalize ->
      float32 ``[C, H, W]`` (`:29-34,61`).
    - ``enable_bucket=True``: the raw ``[H, W, C]`` uint8 pixels (`:63`).
    - load failures retry with a random resample (`:52-58`; bounded here).
    """

    def __init__(self, json_path: str, video_folder: Optional[str] = None,
                 resolution=512, enable_bucket: bool = False,
                 seed: int = 0, max_retries: int = 100):
        with open(json_path, encoding="utf-8") as f:
            self.items = json.load(f)
        self.data_root = video_folder or ""
        res = resolution
        self.resolution = (res, res) if isinstance(res, int) else tuple(res)
        self.enable_bucket = enable_bucket
        self.rng = np.random.default_rng(seed)
        self.max_retries = max_retries

    def _load_one(self, idx: int) -> Dict[str, np.ndarray]:
        import cv2
        item = self.items[idx]
        path = self._path(item["file_path"])
        bgr = cv2.imread(path, cv2.IMREAD_COLOR)
        if bgr is None:
            raise ValueError(f"unreadable image {path}")
        rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        text = item.get("text", "")
        if self.enable_bucket:
            return {"pixel_values": rgb, "text": text, "idx": idx}
        frames = _resize_shortest_center_crop(rgb[None], self.resolution)
        # [C, H, W] float32 in [-1, 1] (ToTensor + Normalize(.5, .5))
        pix = _norm_chw(frames)[:, 0]
        return {"pixel_values": pix, "text": text, "idx": idx}


class VideoDataset(_LegacyVideoDataset):
    """Generic caption-video JSON loader (`dataset_video.py:158-241`):
    a list of ``{file_path, text}``; ``video_folder`` optionally prefixes
    relative paths."""

    def __init__(self, json_path: str, video_folder: Optional[str] = None,
                 **kw):
        kw.pop("is_image", None)    # reference class has no image mode
        with open(json_path, encoding="utf-8") as f:
            items = json.load(f)
        super().__init__(items, video_folder, **kw)

    def _item_path_text(self, item: dict) -> Tuple[str, str]:
        return self._path(item["file_path"]), item.get("text", "")
