"""Aspect-ratio bucketing (a copy of `videocof_tpu/data/buckets.py`;
reference `bucket_sampler.py:13-60,294+`): items are resized into a finite
bucket set so each batch shares one shape."""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Sequence, Tuple

import numpy as np

# (h, w) buckets around 512px area (reference ASPECT_RATIO_512)
ASPECT_RATIO_512: Dict[str, Tuple[float, float]] = {
    '0.25': (256.0, 1024.0), '0.26': (256.0, 992.0), '0.27': (256.0, 960.0),
    '0.28': (256.0, 928.0), '0.32': (288.0, 896.0), '0.33': (288.0, 864.0),
    '0.35': (288.0, 832.0), '0.4': (320.0, 800.0), '0.42': (320.0, 768.0),
    '0.48': (352.0, 736.0), '0.5': (352.0, 704.0), '0.52': (352.0, 672.0),
    '0.57': (384.0, 672.0), '0.6': (384.0, 640.0), '0.68': (416.0, 608.0),
    '0.72': (416.0, 576.0), '0.78': (448.0, 576.0), '0.82': (448.0, 544.0),
    '0.88': (480.0, 544.0), '0.94': (480.0, 512.0), '1.0': (512.0, 512.0),
    '1.07': (512.0, 480.0), '1.13': (544.0, 480.0), '1.21': (544.0, 448.0),
    '1.29': (576.0, 448.0), '1.38': (576.0, 416.0), '1.46': (608.0, 416.0),
    '1.67': (640.0, 384.0), '1.75': (672.0, 384.0), '2.0': (704.0, 352.0),
    '2.09': (736.0, 352.0), '2.4': (768.0, 320.0), '2.5': (800.0, 320.0),
    '2.89': (832.0, 288.0), '3.0': (864.0, 288.0), '3.11': (896.0, 288.0),
    '3.62': (928.0, 256.0), '3.75': (960.0, 256.0), '3.88': (992.0, 256.0),
    '4.0': (1024.0, 256.0),
}


def get_closest_ratio(height: float, width: float,
                      ratios: Dict[str, Tuple[float, float]] = ASPECT_RATIO_512
                      ) -> Tuple[Tuple[float, float], str]:
    ar = height / width
    key = min(ratios, key=lambda r: abs(float(r) - ar))
    return ratios[key], key


class AspectRatioBatchSampler:
    """Groups item indices whose media share a bucket into same-shape batches
    (reference `AspectRatioBatchImageVideoSampler`). ``shapes`` maps index ->
    (height, width). Incomplete groups are yielded at the end unless
    drop_last."""

    def __init__(self, shapes: Sequence[Tuple[int, int]], batch_size: int,
                 ratios=ASPECT_RATIO_512, drop_last: bool = False,
                 shuffle: bool = True, seed: int = 0):
        self.shapes = shapes
        self.batch_size = batch_size
        self.ratios = ratios
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.seed = seed

    def __iter__(self) -> Iterator[List[int]]:
        order = np.arange(len(self.shapes))
        if self.shuffle:
            np.random.default_rng(self.seed).shuffle(order)
        buckets: Dict[str, List[int]] = {}
        for idx in order:
            h, w = self.shapes[idx]
            _, key = get_closest_ratio(h, w, self.ratios)
            b = buckets.setdefault(key, [])
            b.append(int(idx))
            if len(b) == self.batch_size:
                yield b
                buckets[key] = []
        if not self.drop_last:
            for b in buckets.values():
                if b:
                    yield b


def resize_center_crop(frames: np.ndarray, height: int, width: int
                       ) -> np.ndarray:
    """[T, H, W, C] uint8 -> bucket size via aspect-preserving resize + center
    crop (reference `dataset_image_video.py:1524-1536`)."""
    import cv2
    t, h, w, c = frames.shape
    scale = max(height / h, width / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    out = np.empty((t, height, width, c), frames.dtype)
    y0 = (nh - height) // 2
    x0 = (nw - width) // 2
    for i in range(t):
        r = cv2.resize(frames[i], (nw, nh), interpolation=cv2.INTER_AREA
                       if scale < 1 else cv2.INTER_LINEAR)
        out[i] = r[y0:y0 + height, x0:x0 + width]
    return out
