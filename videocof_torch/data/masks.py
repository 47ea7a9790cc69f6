"""Random inpaint-mask generator — behavioural port of the reference's
10-mode `get_random_mask` (`dataset_image_video.py:29-112`), vectorized numpy
(the reference draws circles/ellipses with a Python double loop). A copy of
`videocof_tpu/data/masks.py`."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

_MODE_PROBS = [0.05, 0.2, 0.2, 0.2, 0.05, 0.05, 0.05, 0.1, 0.05, 0.05]


def get_random_mask(shape: Tuple[int, int, int, int],
                    image_start_only: bool = False,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """shape (f, c, h, w) -> uint8 mask [f, 1, h, w] (1 = inpaint region)."""
    f, c, h, w = shape
    rng = rng or np.random.default_rng()
    mask = np.zeros((f, 1, h, w), np.uint8)

    if image_start_only:
        if f != 1:
            mask[1:] = 1
        else:
            mask[:] = 1
        return mask

    if f != 1:
        mode = rng.choice(10, p=_MODE_PROBS)
    else:
        mode = rng.choice([0, 1], p=[0.2, 0.8])

    def rect():
        cx, cy = int(rng.integers(0, w)), int(rng.integers(0, h))
        bx = int(rng.integers(w // 4, w // 4 * 3))
        by = int(rng.integers(h // 4, h // 4 * 3))
        return (max(cy - by // 2, 0), min(cy + by // 2, h),
                max(cx - bx // 2, 0), min(cx + bx // 2, w))

    yy, xx = np.mgrid[0:h, 0:w]

    if mode == 0:      # static rectangle
        y0, y1, x0, x1 = rect()
        mask[:, :, y0:y1, x0:x1] = 1
    elif mode == 1:    # everything
        mask[:] = 1
    elif mode == 2:    # all frames after a random early index
        mask[int(rng.integers(1, 5)):] = 1
    elif mode == 3:    # interior frame band
        k = int(rng.integers(1, 5))
        mask[k:-k] = 1
    elif mode == 4:    # rectangle over a frame band
        y0, y1, x0, x1 = rect()
        f0 = int(rng.integers(0, f // 2))
        f1 = int(rng.integers(f // 2, f))
        mask[f0:f1, :, y0:y1, x0:x1] = 1
    elif mode == 5:    # salt-and-pepper
        mask = rng.integers(0, 2, (f, 1, h, w)).astype(np.uint8)
    elif mode == 6:    # small blocks on random frames
        n = int(rng.integers(1, max(f // 2, 1) + 1))
        for i in rng.choice(f, size=n, replace=False):
            bh = int(rng.integers(1, max(h // 4, 2)))
            bw = int(rng.integers(1, max(w // 4, 2)))
            y0 = int(rng.integers(0, h - bh + 1))
            x0 = int(rng.integers(0, w - bw + 1))
            mask[i, 0, y0:y0 + bh, x0:x0 + bw] = 1
    elif mode == 7:    # ellipse
        cx, cy = int(rng.integers(0, w)), int(rng.integers(0, h))
        a = int(rng.integers(min(w, h) // 8, min(w, h) // 4))
        b = int(rng.integers(min(w, h) // 8, min(w, h) // 4))
        ell = ((yy - cy) ** 2) / b ** 2 + ((xx - cx) ** 2) / a ** 2 < 1
        mask[:, 0][:, ell] = 1
    elif mode == 8:    # circle
        cx, cy = int(rng.integers(0, w)), int(rng.integers(0, h))
        r = int(rng.integers(min(w, h) // 8, min(w, h) // 4))
        circ = (yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2
        mask[:, 0][:, circ] = 1
    elif mode == 9:    # random full frames
        sel = rng.random(f) > 0.5
        mask[sel] = 1
    return mask
