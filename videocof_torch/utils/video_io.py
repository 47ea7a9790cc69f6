"""Host-side video I/O through OpenCV.

Counterpart of `videocof_tpu/utils/video_io.py` (`load_video_frames`,
`save_video`, `save_results`, `save_side_by_side`, `save_videos_grid`,
`color_transfer`, `merge_video_audio`, the i2v and v2v conditioning)
on its cv2 path; the JAX package's native libav runtime
(`videocof_tpu/runtime/`) is not ported (ROADMAP.md): a path handed to
`get_video_to_video_latent` decodes and resizes as JAX's cv2 fallback
does. Frames are stride-sampled as the reference samples them
(`fast_infer.py:43-92`), from a start drawn by the caller's numpy generator,
and the last frame repeats when the clip runs short. Outputs are mp4 (cv2's
``mp4v``), or a PNG sequence where no mp4 writer opens.

Image-to-video conditioning (`get_image_to_video_latent`) reads and resizes
its images through PIL with its default resample (BICUBIC), as JAX's and
the reference's do.
"""

from __future__ import annotations

import os
import shutil
import subprocess
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


def color_transfer(src: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """``src``'s LAB channel statistics matched to ``ref``'s (both uint8
    RGB [H, W, 3]): per channel ``(x - mu_s) * (sigma_r / sigma_s) +
    mu_r`` in LAB (the reference's `color_transfer`,
    `videox_fun/utils/utils.py:31-57`)."""
    cv2 = _cv2()
    s = cv2.cvtColor(src, cv2.COLOR_RGB2LAB).astype(np.float64)
    r = cv2.cvtColor(ref, cv2.COLOR_RGB2LAB).astype(np.float64)
    s_mean = s.reshape(-1, 3).mean(0)
    s_std = np.maximum(s.reshape(-1, 3).std(0), 1e-6)
    r_mean = r.reshape(-1, 3).mean(0)
    r_std = r.reshape(-1, 3).std(0)
    out = (s - s_mean) * (r_std / s_std) + r_mean
    out = np.clip(np.round(out), 0, 255).astype(np.uint8)
    return cv2.cvtColor(out, cv2.COLOR_LAB2RGB)


def save_videos_grid(videos: np.ndarray, path: str, rescale: bool = False,
                     n_rows: int = 6, fps: int = 12,
                     color_transfer_post_process: bool = False) -> None:
    """A batch [B, C, T, H, W] (or one clip [C, T, H, W]) -> one tiled
    video, ``n_rows`` items a grid row, the last row padded with black
    (the reference's `save_videos_grid`, `utils.py:59-83`). ``rescale``
    maps [-1, 1] to [0, 1]; ``color_transfer_post_process`` pins every
    frame's LAB statistics to frame 0's."""
    v = np.asarray(videos)
    if v.ndim == 4:
        v = v[None]
    if rescale:
        v = (v + 1.0) / 2.0
    v = np.clip(v, 0.0, 1.0)
    B, C, T, H, W = v.shape
    cols = min(n_rows, B)
    rows = -(-B // cols)
    pad = rows * cols - B
    if pad:
        v = np.concatenate([v, np.zeros((pad, C, T, H, W), v.dtype)])
    # [rows, cols, C, T, H, W] -> [C, T, rows*H, cols*W]
    grid = (v.reshape(rows, cols, C, T, H, W)
            .transpose(2, 3, 0, 4, 1, 5)
            .reshape(C, T, rows * H, cols * W))
    if color_transfer_post_process and T > 1:
        u8 = (grid * 255).astype(np.uint8).transpose(1, 2, 3, 0)  # [T,H,W,C]
        ref = u8[0]
        u8 = np.stack([ref] + [color_transfer(f, ref) for f in u8[1:]])
        grid = u8.transpose(3, 0, 1, 2).astype(np.float32) / 255.0
    save_video(grid, path, fps)


def merge_video_audio(video_path: str, audio_path: str) -> None:
    """Mux ``audio_path`` onto ``video_path`` in place, cut to the shorter
    stream (the reference's `merge_video_audio`, `utils.py:85-143`: ffmpeg,
    the video stream copied, AAC audio, ``-shortest``). FileNotFoundError
    for a missing input; RuntimeError without ``ffmpeg`` on PATH or when it
    fails."""
    if not os.path.exists(video_path):
        raise FileNotFoundError(f"video file {video_path} does not exist")
    if not os.path.exists(audio_path):
        raise FileNotFoundError(f"audio file {audio_path} does not exist")
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError("merge_video_audio needs ffmpeg on PATH")
    base, ext = os.path.splitext(video_path)
    temp_output = f"{base}_temp{ext}"
    try:
        result = subprocess.run(
            [ffmpeg, "-y", "-i", video_path, "-i", audio_path,
             "-c:v", "copy", "-c:a", "aac", "-b:a", "192k",
             "-map", "0:v:0", "-map", "1:a:0", "-shortest", temp_output],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        if result.returncode != 0:
            raise RuntimeError(f"ffmpeg failed: {result.stderr}")
        shutil.move(temp_output, video_path)
    finally:
        if os.path.exists(temp_output):
            os.remove(temp_output)


def _read_image_rgb(img, size: Optional[Tuple[int, int]] = None
                    ) -> np.ndarray:
    """-> HWC uint8 RGB. ``img``: a path, an HWC array or a PIL image;
    ``size`` = (H, W) resizes through PIL's ``Image.resize`` with its
    default resample (BICUBIC), as the reference does
    (`videox_fun/utils/utils.py:148-162`)."""
    from PIL import Image
    if isinstance(img, str):
        with Image.open(img) as im:
            a = np.asarray(im.convert("RGB"), np.uint8)
    else:
        a = np.asarray(img, np.uint8)
    if size is not None and a.shape[:2] != tuple(size):
        a = np.asarray(Image.fromarray(a).resize((size[1], size[0])),
                       np.uint8)
    return a


def get_image_to_video_latent(image_start, image_end, video_length: int,
                              sample_size: Tuple[int, int]):
    """The image-to-video conditioning (the reference's
    `get_image_to_video_latent`, `videox_fun/utils/utils.py:145-242`).

    ``image_start``/``image_end``: a path, HWC array or PIL image, a list of
    those, or None -> ``(video [1, 3, T, H, W] float in [0, 1], mask
    [1, 1, T, H, W] 0/255, clip_image HWC uint8 or None)``: the start
    frame(s) fill the head (mask 0 = keep), the rest repeats the first
    start frame under mask 255 (= generate); end frame(s) overwrite the
    tail with mask 0."""
    H, W = sample_size
    if image_start is None:
        video = np.zeros((1, 3, video_length, H, W), np.float32)
        mask = np.full((1, 1, video_length, H, W), 255.0, np.float32)
        return video, mask, None
    starts = image_start if isinstance(image_start, list) else [image_start]
    starts = [_read_image_rgb(s, (H, W)) for s in starts]
    clip_image = starts[0]
    head = np.stack(starts).transpose(3, 0, 1, 2)[None]   # [1, 3, k, H, W]
    video = np.tile(head[:, :, :1], (1, 1, video_length, 1, 1))
    video[:, :, :len(starts)] = head
    mask = np.zeros((1, 1, video_length, H, W), np.float32)
    mask[:, :, len(starts):] = 255.0
    if image_end is not None:
        ends = image_end if isinstance(image_end, list) else [image_end]
        ends = [_read_image_rgb(e, (H, W)) for e in ends]
        video[:, :, -len(ends):] = np.stack(ends).transpose(3, 0, 1, 2)[None]
        mask[:, :, -len(ends):] = 0.0
    return video.astype(np.float32) / 255.0, mask, clip_image


def get_video_to_video_latent(input_video_path, video_length: int,
                              sample_size: Tuple[int, int],
                              fps: Optional[int] = None,
                              validation_video_mask: Optional[str] = None,
                              ref_image=None):
    """The video-to-video conditioning (the reference's
    `get_video_to_video_latent`, `videox_fun/utils/utils.py:244-300`).

    -> ``(video [1, 3, T, H, W] in [0, 1] or None, mask [1, 1, T, H, W]
    or None, ref_image [1, 3, 1, H, W] in [0, 1] or None, clip_image HWC
    uint8 or None)``. ``input_video_path``: a path, decoded through cv2
    with every frame resized to ``sample_size`` by ``cv2.resize``'s
    default (bilinear), one frame in ``src_fps // fps``, at most
    ``video_length``; or an array [T, H, W, 3] uint8, taken as it is. The
    mask image (PIL ``'L'``, resized with PIL's default) is 0 (keep) below
    240 and 255 (generate) from it, tiled over T; without one every frame
    is 255. A ref image given as a path is resized to (H, W), an array is
    not."""
    H, W = sample_size
    video = mask = None
    if input_video_path is not None:
        if isinstance(input_video_path, str):
            cv2 = _cv2()
            total, _, _, src_fps = video_info(input_video_path)
            skip = 1 if fps is None else max(1, int(src_fps // fps))
            idx = list(range(0, total, skip))[:video_length]
            rgb = decode_frames_u8(input_video_path, idx)   # [T, h, w, 3]
            rgb = np.stack([cv2.resize(f, (W, H)) for f in rgb])
            dec = rgb.astype(np.float32) * (2.0 / 255.0) - 1.0
            video = ((dec + 1.0) * 0.5).clip(0, 1).transpose(3, 0, 1, 2)[None]
        else:
            arr = np.asarray(input_video_path)[:video_length]  # [T,H,W,3]
            video = arr.transpose(3, 0, 1, 2)[None].astype(np.float32) / 255.0
        T = video.shape[2]
        if validation_video_mask is not None:
            from PIL import Image
            with Image.open(validation_video_mask) as im:
                m = np.asarray(im.convert("L").resize((W, H)))
            m = np.where(m < 240, 0.0, 255.0).astype(np.float32)
            mask = np.tile(m[None, None, None], (1, 1, T, 1, 1))
        else:
            mask = np.full((1, 1, T) + video.shape[3:], 255.0, np.float32)
    clip_image = None if ref_image is None else _read_image_rgb(ref_image)
    ref = None
    if ref_image is not None:
        r = _read_image_rgb(ref_image,
                            (H, W) if isinstance(ref_image, str) else None)
        ref = r.transpose(2, 0, 1)[None, :, None].astype(np.float32) / 255.0
    return video, mask, ref, clip_image


def size_from_base_resolution(height: int, width: int,
                              base_resolution: int = 512
                              ) -> Tuple[int, int]:
    """(H, W) scaled so that H * W is about base_resolution ** 2 at the
    input's aspect ratio (the reference's
    `get_width_and_height_from_image_and_base_resolution`,
    `videox_fun/utils/utils.py:23-29`)."""
    ratio = (float(base_resolution) ** 2 / (float(width) * float(height))
             ) ** 0.5
    return round(height * ratio), round(width * ratio)
