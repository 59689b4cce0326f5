"""Geometric / photometric augmentations (host-side, numpy/cv2), a copy of
the JAX package's: the same outputs for the same generator.

Capability port of the reference's kornia-based utilities
(the reference's romatch/utils/transforms.py): paired RandomErasing that
blanks image AND depth together (:108-117), and in-plane rotation applied as
a homography with the intrinsics composed accordingly (GeometricSequential /
RandomAffine, :8-32 — used by the ScanNet recipe via rot_prob). Both are
default-off in the shipped reference configs, matching our defaults.
"""

from __future__ import annotations

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None


def random_erasing(
    im: np.ndarray,
    depth: np.ndarray,
    rng: np.random.Generator,
    p: float = 0.5,
    scale: tuple[float, float] = (0.02, 0.1),
    ratio: tuple[float, float] = (0.3, 3.3),
) -> tuple[np.ndarray, np.ndarray]:
    """Blank one random rectangle in both image (H, W, 3) and depth (H, W) —
    erased pixels must drop out of the GT warp supervision too, hence the
    paired depth zeroing."""
    if rng.random() > p:
        return im, depth
    h, w = depth.shape
    area = h * w * rng.uniform(*scale)
    r = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
    eh = int(round(np.sqrt(area * r)))
    ew = int(round(np.sqrt(area / r)))
    eh, ew = min(eh, h - 1), min(ew, w - 1)
    if eh < 1 or ew < 1:
        return im, depth
    y = rng.integers(0, h - eh)
    x = rng.integers(0, w - ew)
    im = im.copy()
    depth = depth.copy()
    im[y : y + eh, x : x + ew] = 0.0
    depth[y : y + eh, x : x + ew] = 0.0
    return im, depth


def random_rotation(
    im: np.ndarray,
    depth: np.ndarray,
    K: np.ndarray,
    rng: np.random.Generator,
    max_deg: float = 90.0,
    p: float = 1.0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """In-plane rotation about the image center as a homography H; the
    intrinsics compose as K' = H K so depth-based GT warping stays
    consistent (pure in-plane rotation is depth-independent)."""
    if cv2 is None or rng.random() > p:
        return im, depth, K
    h, w = depth.shape
    ang = rng.uniform(-max_deg, max_deg)
    H2 = cv2.getRotationMatrix2D((w / 2, h / 2), ang, 1.0)
    H3 = np.eye(3)
    H3[:2] = H2
    im_r = cv2.warpAffine(im, H2, (w, h), flags=cv2.INTER_LINEAR)
    depth_r = cv2.warpAffine(depth, H2, (w, h), flags=cv2.INTER_NEAREST)
    return im_r, depth_r, H3 @ K


def color_jiggle(
    im: np.ndarray,
    rng: np.random.Generator,
    brightness: float = 0.1,
    contrast: float = 0.1,
    saturation: float = 0.1,
    hue: float = 0.05,
) -> np.ndarray:
    """Photometric jitter on a float [0,1] HWC image (kornia
    ColorJiggle-style factors). The reference ACCEPTS colorjiggle_params
    (megadepth.py:29,61) but its get_tuple_transform_ops silently ignores
    them (utils.py:165-174 never appends a jiggle op), and use_randaug
    calls an undefined `rand_augment` (megadepth.py:134 — crashes). This is
    the working implementation of the advertised capability."""
    b = 1.0 + rng.uniform(-brightness, brightness)
    c = 1.0 + rng.uniform(-contrast, contrast)
    s = 1.0 + rng.uniform(-saturation, saturation)
    h = rng.uniform(-hue, hue)

    out = im * b
    mean = out.mean(axis=(0, 1), keepdims=True)
    out = (out - mean) * c + mean
    gray = out @ np.array([0.299, 0.587, 0.114], np.float32)
    out = (out - gray[..., None]) * s + gray[..., None]
    if h != 0.0:
        # hue rotation in YIQ space (cheap, no cv2 dependency)
        t = 2 * np.pi * h
        u, w = np.cos(t), np.sin(t)
        yiq = np.array(
            [[0.299, 0.587, 0.114],
             [0.596, -0.274, -0.322],
             [0.211, -0.523, 0.312]], np.float32,
        )
        rot = np.array([[1, 0, 0], [0, u, -w], [0, w, u]], np.float32)
        m = np.linalg.inv(yiq) @ rot @ yiq
        out = out @ m.T
    return np.clip(out, 0.0, 1.0).astype(np.float32)
