"""The reference's non-CoT dataset family, numpy-native.

Behavioural rebuilds of `videox_fun/data/dataset_image_video.py`:

- :class:`ImageVideoDataset` (`:724-891`) — generic t2v/i2v items (mixed
  image/video annotation lists, video_repeat balancing, windowed stride
  sampling, text drop).
- :class:`ImageVideoControlDataset` (`:1680-1903`) — adds a control stream
  per item: a control *video*, or (``enable_camera_info``) a RealEstate10K
  pose ``.txt`` rendered to a Plücker-ray embedding (`data/camera.py`) and
  linearly resampled to the clip length.
- :class:`VideoEditDataset` (`:375-543`) — (source, edited) video pairs with
  the two-part edit-instruction template.
- :class:`VideoEditReasoningDataset` (`:544-723`) — the earlier triplet
  variant superseded by `dataset.CoTTripletDataset`; kept as a thin subclass
  so checkpoints/configs that name it keep working.

All loaders return plain numpy dicts ([C, T, H, W] float32 in [-1, 1]) and
retry with a random resample on decode failure, like the reference. Device
work (VAE encode etc.) happens later, in the trainer. A copy of
`videocof_tpu/data/datasets_extra.py`.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, List, Optional

import numpy as np

from .buckets import resize_center_crop
from .camera import process_pose_file
from .dataset import CoTTripletDataset, _frame_count, _read_frames_at


def _load_annotations(ann_path: str) -> List[dict]:
    """JSON list / JSON dict-of-items / CSV rows (reference `:739-744`)."""
    if ann_path.endswith(".csv"):
        with open(ann_path, encoding="utf-8") as f:
            return list(csv.DictReader(f))
    with open(ann_path, encoding="utf-8") as f:
        data = json.load(f)
    if isinstance(data, dict):
        out = []
        for _vid, info in data.items():
            row = dict(info)
            row.setdefault("text", info.get("edit_instruction", ""))
            out.append(row)
        return out
    return data


def _norm_chw(frames_u8: np.ndarray) -> np.ndarray:
    """uint8 [T, H, W, C] -> float32 [C, T, H, W] in [-1, 1]."""
    out = frames_u8.transpose(3, 0, 1, 2).astype(np.float32)
    return out * (2.0 / 255.0) - 1.0


def _window_indices(total: int, n_frames: int, stride: int,
                    drop_start: float, drop_end: float,
                    rng: np.random.Generator) -> List[int]:
    """Stride-sample ``n_frames`` from the [drop_start, drop_end) window of
    the clip with a random start (reference `:805-818`); clamp when short."""
    lo = int(total * drop_start)
    hi = max(lo + 1, int(total * drop_end))
    span = hi - lo
    need = (n_frames - 1) * stride + 1
    start = lo + int(rng.integers(0, max(1, span - need + 1)))
    return [min(start + i * stride, hi - 1) for i in range(n_frames)]


class _RetryDataset:
    """Shared loader plumbing: ``data_root`` path join and the reference's
    retry-with-random-resample ``__getitem__``
    (`dataset_image_video.py:1617-1650`). Subclasses set ``items``,
    ``data_root``, ``rng``, ``max_retries`` and implement ``_load_one``."""

    def __len__(self) -> int:
        return len(self.items)

    def _path(self, p: str) -> str:
        return os.path.join(self.data_root, p) if self.data_root else p

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        for _ in range(self.max_retries):
            try:
                return self._load_one(idx)
            except Exception:
                idx = int(self.rng.integers(0, len(self.items)))
        raise RuntimeError("dataset: too many consecutive load failures")


class ImageVideoDataset(_RetryDataset):
    """Generic t2v/i2v loader: each item is ``{file_path, text, type}`` with
    ``type`` 'video' or 'image'."""

    def __init__(self, ann_path: str, data_root: Optional[str] = None,
                 video_sample_size=512, video_sample_stride: int = 4,
                 video_sample_n_frames: int = 16, image_sample_size=512,
                 video_repeat: int = 0, text_drop_ratio: float = 0.1,
                 video_length_drop_start: float = 0.0,
                 video_length_drop_end: float = 1.0,
                 seed: int = 0, max_retries: int = 100):
        items = _load_annotations(ann_path)
        if video_repeat > 0:
            # balance images vs videos: images once, videos repeated
            # (reference `:748-760`)
            balanced = [d for d in items if d.get("type", "image") != "video"]
            for _ in range(video_repeat):
                balanced += [d for d in items
                             if d.get("type", "image") == "video"]
            items = balanced
        self.items = items
        self.data_root = data_root
        vs = video_sample_size
        self.video_sample_size = (vs, vs) if isinstance(vs, int) else tuple(vs)
        ims = image_sample_size
        self.image_sample_size = ((ims, ims) if isinstance(ims, int)
                                  else tuple(ims))
        self.video_sample_stride = video_sample_stride
        self.video_sample_n_frames = video_sample_n_frames
        self.text_drop_ratio = text_drop_ratio
        self.video_length_drop_start = video_length_drop_start
        self.video_length_drop_end = video_length_drop_end
        self.rng = np.random.default_rng(seed)
        self.max_retries = max_retries

    def _read_image(self, path: str) -> np.ndarray:
        import cv2
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)[None]     # [1, H, W, 3]

    def _load_one(self, idx: int) -> Dict[str, np.ndarray]:
        item = self.items[idx]
        path = self._path(item.get("file_path", item.get("video_path", "")))
        kind = item.get("type", "image")
        if kind == "video":
            total = _frame_count(path)
            indices = _window_indices(
                total, self.video_sample_n_frames, self.video_sample_stride,
                self.video_length_drop_start, self.video_length_drop_end,
                self.rng)
            frames = _read_frames_at(path, indices)
            h, w = self.video_sample_size
        else:
            total, indices = 1, [0]
            frames = self._read_image(path)
            h, w = self.image_sample_size
        frames = resize_center_crop(frames, h, w)
        text = item.get("text", item.get("caption", ""))
        if self.rng.random() < self.text_drop_ratio:
            text = ""
        # frame_indices/total_frames let subclasses sample paired streams at
        # the SAME moments (reference reads main and control video at one
        # shared batch_index — `dataset_image_video.py:1834,1843-1845`)
        return {"pixel_values": _norm_chw(frames), "text": text,
                "type": kind, "idx": idx, "frame_indices": indices,
                "total_frames": total}


def _resample_time(arr: np.ndarray, new_t: int) -> np.ndarray:
    """Linear resample along axis 0 with align_corners semantics (the
    reference's bilinear `F.interpolate` over (time, width) `:1826-1827`)."""
    t = arr.shape[0]
    if t == new_t:
        return arr
    pos = (np.linspace(0.0, t - 1.0, new_t) if new_t > 1
           else np.zeros((1,)))
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, t - 1)
    w = (pos - lo).reshape((-1,) + (1,) * (arr.ndim - 1)).astype(np.float32)
    return arr[lo] * (1.0 - w) + arr[hi] * w


class ImageVideoControlDataset(ImageVideoDataset):
    """Adds the per-item control stream (``control_file_path``)."""

    def __init__(self, *args, enable_camera_info: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.enable_camera_info = enable_camera_info

    def _load_one(self, idx: int) -> Dict[str, np.ndarray]:
        sample = super()._load_one(idx)
        item = self.items[sample.pop("idx")]
        ctrl = self._path(item.get("control_file_path", ""))
        h, w = sample["pixel_values"].shape[2:]
        # the control stream must pair frame-for-frame with the sampled main
        # frames: reference reads both videos at ONE shared batch_index
        # (`dataset_image_video.py:1834,1843-1845`), so reuse the indices
        indices = list(sample["frame_indices"])
        if self.enable_camera_info and ctrl.lower().endswith(".txt"):
            # pose txt -> [T0, H, W, 6] Plücker map, interpolated to the
            # FULL clip length then picked at the sampled indices
            # (reference `:1822-1828`); control video zeroed
            emb = process_pose_file(ctrl, width=w, height=h)
            emb = _resample_time(emb, sample["total_frames"])[indices]
            sample["control_camera_values"] = emb.transpose(0, 3, 1, 2)
            sample["control_pixel_values"] = np.zeros_like(
                sample["pixel_values"])
        else:
            total = _frame_count(ctrl)
            clamped = [min(i, total - 1) for i in indices]
            frames = resize_center_crop(_read_frames_at(ctrl, clamped), h, w)
            sample["control_pixel_values"] = _norm_chw(frames)
            sample["control_camera_values"] = None
        return sample


class VideoEditDataset(_RetryDataset):
    """(source, edited) video-pair loader with the two-part instruction
    template (reference `:375-543`)."""

    TEMPLATE = ("A video sequence showing two parts: the first half shows "
                "the original scene, and the second half shows the same "
                "scene but {edit_instruction}")

    def __init__(self, ann_path: str, data_root: Optional[str] = None,
                 height: int = 480, width: int = 832,
                 source_frames: int = 33, edit_frames: int = 32,
                 text_drop_ratio: float = 0.1, seed: int = 0,
                 max_retries: int = 100):
        self.items = _load_annotations(ann_path)
        self.data_root = data_root
        self.height, self.width = height, width
        self.source_frames = source_frames
        self.edit_frames = edit_frames
        self.text_drop_ratio = text_drop_ratio
        self.rng = np.random.default_rng(seed)
        self.max_retries = max_retries

    def _load_one(self, idx: int) -> Dict[str, np.ndarray]:
        item = self.items[idx]
        src = self._path(item.get("original_video", ""))
        edt = self._path(item.get("edited_video", src))
        instruction = item.get("edit_instruction", item.get("text", ""))
        # both streams sampled over the SHORTER clip so frame i of the pair
        # depicts the same moment (reference `:428-470` min_length)
        total = min(_frame_count(src), _frame_count(edt))
        src_idx = np.linspace(0, total - 1, self.source_frames).astype(int)
        edt_idx = np.linspace(0, total - 1, self.edit_frames).astype(int)

        def read(path, indices):
            return resize_center_crop(_read_frames_at(path, list(indices)),
                                      self.height, self.width)

        text = self.TEMPLATE.format(edit_instruction=instruction)
        if self.rng.random() < self.text_drop_ratio:
            text = ""
        return {"pixel_src": _norm_chw(read(src, src_idx)),
                "pixel_tgt": _norm_chw(read(edt, edt_idx)),
                "text": text, "edit_instruction": instruction}


class VideoEditReasoningDataset(CoTTripletDataset):
    """The earlier fixed-count triplet loader (reference `:544-723`) — the
    same contract `CoTTripletDataset` implements; kept as an alias so
    configs naming it resolve."""
