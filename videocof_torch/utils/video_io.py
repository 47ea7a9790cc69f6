"""Host-side video I/O through OpenCV.

Counterpart of `videocof_tpu/utils/video_io.py` (`load_video_frames`,
`save_video`, `save_results`, `save_side_by_side`) on its cv2 path; the JAX
package's native libav runtime (`videocof_tpu/runtime/`) is not ported
(ROADMAP.md). Frames are stride-sampled as the reference samples them
(`fast_infer.py:43-92`), from a start drawn by the caller's numpy generator,
and the last frame repeats when the clip runs short. Outputs are mp4 (cv2's
``mp4v``), or a PNG sequence where no mp4 writer opens.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as exc:
        raise RuntimeError(
            "video decoding and encoding need OpenCV (the cv2 module), which "
            "is not importable; the native libav runtime of the JAX package "
            "is not ported (ROADMAP.md)") from exc
    return cv2


def video_info(path: str) -> Tuple[int, int, int, float]:
    """-> (frames, height, width, fps) as the container reports them."""
    cv2 = _cv2()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {path}")
    info = (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            float(cap.get(cv2.CAP_PROP_FPS)))
    cap.release()
    return info


def decode_frames_u8(path: str, indices: Sequence[int]) -> np.ndarray:
    """-> uint8 RGB [T, H, W, 3] of the non-decreasing frame ``indices``, in
    one sequential walk; the last decoded frame repeats for indices past
    the clip's end."""
    cv2 = _cv2()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {path}")
    want = list(indices)
    frames: List[np.ndarray] = []
    pos = 0
    try:
        while len(frames) < len(want):
            ok, frame = cap.read()
            if not ok:
                break
            while len(frames) < len(want) and want[len(frames)] == pos:
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            pos += 1
    finally:
        cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    frames += [frames[-1]] * (len(want) - len(frames))
    return np.stack(frames)


def load_video_frames(video_path: str, source_frames: int,
                      rng: Optional[np.random.Generator] = None,
                      dtype: str = "uint8") -> Tuple[np.ndarray, int, int]:
    """-> (video, height, width). ``dtype="uint8"``: [1, 3, T, H, W] in
    [0, 255] (the pipeline normalizes on the device); ``"float32"``: the
    same in [-1, 1] (``x * 2/255 - 1``); ``"i420"``: packed 4:2:0 planes
    [1, T, H*3//2, W] uint8 (half the bytes of uint8 RGB; odd H or W falls
    back to uint8 RGB). Frames are stride-sampled: stride = total //
    source_frames, start drawn from ``rng`` (default
    ``np.random.default_rng(0)``), the last frame repeated if the clip runs
    short."""
    if dtype not in ("uint8", "float32", "i420"):
        raise ValueError(f"dtype {dtype!r}: uint8, float32 or i420")
    total, h, w, _ = video_info(video_path)
    if total < 1:
        raise ValueError(f"no frames in {video_path}")
    stride = max(1, total // source_frames)
    hi = max(1, total - stride * source_frames)
    rng = rng or np.random.default_rng(0)
    start = int(rng.integers(0, hi))
    idx = [min(start + i * stride, total - 1) for i in range(source_frames)]
    rgb = decode_frames_u8(video_path, idx)            # [T, H, W, 3]
    if dtype == "i420" and h % 2 == 0 and w % 2 == 0:
        cv2 = _cv2()
        return np.stack([cv2.cvtColor(f, cv2.COLOR_RGB2YUV_I420)
                         for f in rgb])[None], h, w
    video = rgb.transpose(3, 0, 1, 2)[None]            # [1, 3, T, H, W]
    if dtype == "float32":
        video = video.astype(np.float32) * (2.0 / 255.0) - 1.0
    return np.ascontiguousarray(video), h, w


def save_video(video: np.ndarray, path: str, fps: int = 16) -> None:
    """video [C, T, H, W] (or [B, C, T, H, W], the first item) in [0, 1] ->
    an mp4, or a PNG sequence in a directory named after ``path`` where no
    mp4 writer opens."""
    cv2 = _cv2()
    if video.ndim == 5:
        video = video[0]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _, _, h, w = video.shape
    frames = (np.clip(video, 0, 1) * 255).astype(np.uint8)
    frames = frames.transpose(1, 2, 3, 0)              # [T, H, W, C]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
    if not writer.isOpened():
        base = os.path.splitext(path)[0]
        os.makedirs(base, exist_ok=True)
        for i, fr in enumerate(frames):
            cv2.imwrite(os.path.join(base, f"{i:05d}.png"),
                        cv2.cvtColor(fr, cv2.COLOR_RGB2BGR))
        return
    try:
        for fr in frames:
            writer.write(cv2.cvtColor(fr, cv2.COLOR_RGB2BGR))
    finally:
        writer.release()


def save_results(video: np.ndarray, path: str, fps: int = 16) -> None:
    """A single frame -> png, else mp4 (reference `fast_infer.py:176-188`)."""
    if video.ndim == 5:
        video = video[0]
    if video.shape[1] == 1:
        cv2 = _cv2()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        img = (np.clip(video[:, 0], 0, 1) * 255).astype(np.uint8)
        cv2.imwrite(os.path.splitext(path)[0] + ".png",
                    cv2.cvtColor(img.transpose(1, 2, 0), cv2.COLOR_RGB2BGR))
        return
    save_video(video, path, fps)


def _to01(x: np.ndarray) -> np.ndarray:
    if x.dtype == np.uint8:
        return x.astype(np.float32) / 255.0
    if x.min() < 0.0 or x.max() > 1.0:
        x = (x + 1.0) / 2.0
    return np.clip(x, 0.0, 1.0)


def save_side_by_side(input_video: np.ndarray, sample: np.ndarray, path: str,
                      fps: int = 16) -> None:
    """Input | output side by side, cropped to their common T, H and W
    (`fast_infer.py:196-209`)."""
    a, b = _to01(np.asarray(input_video)), _to01(np.asarray(sample))
    if a.ndim == 5:
        a = a[0]
    if b.ndim == 5:
        b = b[0]
    t = min(a.shape[1], b.shape[1])
    h = min(a.shape[2], b.shape[2])
    w = min(a.shape[3], b.shape[3])
    save_video(np.concatenate([a[:, :t, :h, :w], b[:, :t, :h, :w]], axis=3),
               path, fps)
