"""Camera-pose conditioning: Plücker-ray embeddings.

Behavioural rebuild of the reference's CameraCtrl-derived pose pipeline
(`videox_fun/data/dataset_image_video.py:114-259`): parse RealEstate10K-style
pose files, re-express every camera relative to the first one, and rasterize
each camera into a per-pixel Plücker-coordinate ray map ``[T, H, W, 6]``
(`[o x d, d]``) that `models/camera_adapter.SimpleAdapter` consumes.

Pure numpy — host-side data preparation (the device never sees a matrix
inverse or a file parse). A copy of `videocof_tpu/data/camera.py`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np


@dataclass
class CameraPose:
    """One pose-file row: ``[frame_id, fx, fy, cx, cy, _, _, w2c(12)]``
    (reference ``Camera.__init__``, `dataset_image_video.py:114-128`).
    Intrinsics are stored normalized (fractions of W/H, as in the files)."""
    fx: float
    fy: float
    cx: float
    cy: float
    w2c: np.ndarray          # [4, 4]

    @classmethod
    def from_entry(cls, entry: Sequence[float]) -> "CameraPose":
        entry = [float(x) for x in entry]
        fx, fy, cx, cy = entry[1:5]
        w2c = np.eye(4, dtype=np.float64)
        w2c[:3, :] = np.asarray(entry[7:19]).reshape(3, 4)
        return cls(fx, fy, cx, cy, w2c)

    @property
    def c2w(self) -> np.ndarray:
        return np.linalg.inv(self.w2c)


def relative_poses(cams: List[CameraPose]) -> np.ndarray:
    """[T, 4, 4] camera-to-world, re-based so camera 0 sits at the canonical
    frame: pose 0 = identity, pose i = w2c[0] @ c2w[i] (reference
    `get_relative_pose`, `dataset_image_video.py:139-154` with
    ``cam_to_origin=0`` so ``target_cam_c2w`` is the identity)."""
    abs2rel = cams[0].w2c
    out = [np.eye(4)] + [abs2rel @ c.c2w for c in cams[1:]]
    return np.asarray(out, dtype=np.float32)


def plucker_rays(K: np.ndarray, c2w: np.ndarray, height: int,
                 width: int) -> np.ndarray:
    """Plücker ray map for each camera: ``[T, H, W, 6] = [o x d | d]``.

    K: [T, 4] pixel-space intrinsics (fx, fy, cx, cy); c2w: [T, 4, 4].
    Matches reference `ray_condition` (`dataset_image_video.py:156-196`):
    pixel centers at +0.5, camera-space directions normalized BEFORE the
    world rotation, ray origin = camera center.
    """
    K = np.asarray(K, np.float32)
    c2w = np.asarray(c2w, np.float32)
    T = K.shape[0]
    j, i = np.meshgrid(np.arange(height, dtype=np.float32),
                       np.arange(width, dtype=np.float32), indexing="ij")
    i = i.reshape(-1) + 0.5                                   # [HW]
    j = j.reshape(-1) + 0.5
    fx, fy, cx, cy = (K[:, k][:, None] for k in range(4))     # [T, 1]
    xs = (i[None] - cx) / fx                                  # [T, HW]
    ys = (j[None] - cy) / fy
    zs = np.ones_like(xs)
    d = np.stack([xs, ys, zs], axis=-1)                       # [T, HW, 3]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays_d = np.einsum("thc,trc->thr", d, c2w[:, :3, :3])     # d @ R^T
    rays_o = np.broadcast_to(c2w[:, None, :3, 3], rays_d.shape)
    plucker = np.concatenate([np.cross(rays_o, rays_d), rays_d], axis=-1)
    return plucker.reshape(T, height, width, 6).astype(np.float32)


def pose_params_to_embedding(cam_params: Sequence[Sequence[float]],
                             width: int, height: int,
                             original_pose_width: int = 1280,
                             original_pose_height: int = 720) -> np.ndarray:
    """Pose rows -> ``[T, H, W, 6]`` Plücker embedding at the sample size.

    Aspect-fit intrinsic rescale (reference `process_pose_params`,
    `dataset_image_video.py:232-259`): when the pose aspect is wider than the
    sample, fx is scaled by the virtual resized width (and vice versa for
    fy), then intrinsics go to pixels as (fx*W, fy*H, cx*W, cy*H).
    """
    cams = [CameraPose.from_entry(e) for e in cam_params]
    sample_ratio = width / height
    pose_ratio = original_pose_width / original_pose_height
    if pose_ratio > sample_ratio:
        resized_w = height * pose_ratio
        for c in cams:
            c.fx = resized_w * c.fx / width
    else:
        resized_h = width / pose_ratio
        for c in cams:
            c.fy = resized_h * c.fy / height
    K = np.asarray([[c.fx * width, c.fy * height, c.cx * width,
                     c.cy * height] for c in cams], np.float32)
    return plucker_rays(K, relative_poses(cams), height, width)


def process_pose_file(path: str, width: int = 672, height: int = 384,
                      original_pose_width: int = 1280,
                      original_pose_height: int = 720,
                      return_poses: bool = False):
    """RealEstate10K-style pose txt (header line + one row per frame) ->
    ``[T, H, W, 6]`` embedding, or the raw rows when ``return_poses``
    (reference `process_pose_file`, `dataset_image_video.py:198-230`)."""
    with open(path, encoding="utf-8") as f:
        lines = f.readlines()
    rows = [[float(x) for x in ln.strip().split(" ")] for ln in lines[1:]]
    if return_poses:
        return rows
    return pose_params_to_embedding(rows, width, height,
                                    original_pose_width,
                                    original_pose_height)
