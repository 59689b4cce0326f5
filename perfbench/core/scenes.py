"""Training batches of the dataset contract (`im_A`, `im_B` (B, H, W, 3)
ImageNet-normalised float32, `im_A_depth`, `im_B_depth` (B, H, W),
`T_1to2` (B, 4, 4), `K1`, `K2` (B, 3, 3)), made from the seed at set-up and
kept in host memory as a data loader hands them.

A traffic file gives `pairs` a batch, the `resolution` (H, W), the `pool`
of batches and the scene's ranges. Each pair is two views of one textured
plane, so that the ground-truth warp, its masks and the anchors' labels
are those of real overlapping views:
- camera A at the origin looking down +z, focal `focal` x W, the principal
  point at the image's centre; the plane through (0, 0, D), D uniform in
  `depth`, its normal tilted from the optical axis by `tilt_deg` about a
  random axis in the image plane;
- camera B turned by `rotation_deg` about a random axis and placed on its
  own optical axis through the plane's centre, at D times `distance`: the
  baseline is about the angle times D (0.1-0.3 D for 5-15 degrees);
  geometry is drawn again until at least `min_overlap` of A's pixels see
  the plane inside B;
- each image is the plane's texture (random fields at 1/16, 1/4 and 1/1
  of `texture` texels, as `inputs.TEXTURE`) seen through the view's rays,
  and each depth map the plane's depth along that view's axis, with
  `holes` of it zeroed (the lowest share of a smooth random field), as
  MegaDepth's depth maps have holes.
No flip or shake: the pool is fixed. Every seed draws the same shapes and
work; the seed changes the content. Images and depths are made on the
device, a batch at a time; the geometry on the host, in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.core.inputs import TEXTURE
from perfbench.core.seeds import derive

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def rotation(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rodrigues' rotation about a unit axis by `angle` radians."""
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + math.sin(angle) * k + (1 - math.cos(angle)) * k @ k


def _unit(rng, flat: bool = False) -> np.ndarray:
    v = rng.normal(size=3)
    if flat:
        v[2] = 0.0
    return v / np.linalg.norm(v)


def _intersect(K: np.ndarray, R: np.ndarray, C: np.ndarray, n: np.ndarray, P0: np.ndarray,
               u: np.ndarray, v: np.ndarray):
    """World points and depths where the rays of pixel coordinates (u, v)
    of the camera (K, camera-to-world R, centre C) meet the plane."""
    rays = R @ (np.linalg.inv(K) @ np.stack([u, v, np.ones_like(u)]))
    s = (n @ (P0 - C)) / (n @ rays)
    return C[:, None] + s * rays, s


def overlap(g: dict, h: int, w: int, step: int = 8) -> float:
    """Share of A's pixels (a grid of one in `step`) whose plane point lies
    in front of B and inside its image."""
    v, u = np.mgrid[step / 2:h:step, step / 2:w:step]
    X, s = _intersect(g["K"], np.eye(3), np.zeros(3), g["n"], g["P0"], u.ravel(), v.ravel())
    Xb = g["R"].T @ (X - g["C"][:, None])
    pb = g["K"] @ Xb
    x, y = pb[0] / pb[2], pb[1] / pb[2]
    ok = (s > 0) & (Xb[2] > 0) & (x > 0) & (x < w - 1) & (y > 0) & (y < h - 1)
    return float(ok.mean())


def draw_geometry(rng, traffic: dict) -> dict:
    """One pair's plane and cameras, drawn again until they overlap enough."""
    h, w = traffic["resolution"]
    f = traffic["focal"] * w
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
    for _ in range(1000):
        D = rng.uniform(*traffic["depth"])
        P0 = np.array([0.0, 0.0, D])
        n = rotation(_unit(rng, flat=True), math.radians(rng.uniform(*traffic["tilt_deg"])))
        n = n @ np.array([0.0, 0.0, -1.0])
        R = rotation(_unit(rng), math.radians(rng.uniform(*traffic["rotation_deg"])))
        C = P0 - D * rng.uniform(*traffic["distance"]) * R[:, 2]
        g = {"K": K, "P0": P0, "n": n, "R": R, "C": C}
        if overlap(g, h, w) >= traffic["min_overlap"]:
            return g
    raise RuntimeError("no geometry with the traffic's overlap in 1000 draws")


def _plane_basis(n: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    e1 = np.cross(n, [0.0, 1.0, 0.0])
    e1 /= np.linalg.norm(e1)
    return e1, np.cross(n, e1)


def _view(g: dict, R: np.ndarray, C: np.ndarray, h: int, w: int, extent: float):
    """Texture coordinates in [-1, 1] (h, w, 2) and depth (h, w) of a view."""
    v, u = np.mgrid[0.5:h:1.0, 0.5:w:1.0]
    X, s = _intersect(g["K"], R, C, g["n"], g["P0"], u.ravel(), v.ravel())
    e1, e2 = _plane_basis(g["n"])
    d = X - g["P0"][:, None]
    uv = np.stack([e1 @ d, e2 @ d], -1) / extent
    return uv.reshape(h, w, 2), s.reshape(h, w)


def make_pool(traffic: dict, seed: int, device) -> list[dict]:
    pairs, pool = traffic["pairs"], traffic["pool"]
    h, w = traffic["resolution"]
    T = traffic["texture"]
    rng = np.random.default_rng(derive(seed, "scenes"))
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "textures"))
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    out = []
    for _ in range(pool):
        geo = [draw_geometry(rng, traffic) for _ in range(pairs)]
        uv, depth = [], []
        for R_C in (lambda g: (np.eye(3), np.zeros(3)), lambda g: (g["R"], g["C"])):
            for g in geo:
                # the texture spans the plane's depth each way of its centre
                t, z = _view(g, *R_C(g), h, w, g["P0"][2])
                uv.append(t)
                depth.append(z)
        tex = 0.0
        for share, down in TEXTURE:
            noise = torch.rand((pairs, 3, -(-T // down), -(-T // down)), generator=gen,
                               device=device)
            tex = tex + share * F.interpolate(noise, size=(T, T), mode="bilinear",
                                              align_corners=False)
        coords = torch.as_tensor(np.stack(uv), dtype=torch.float32, device=device)
        im = torch.cat([F.grid_sample(tex, c, mode="bilinear", padding_mode="reflection",
                                      align_corners=False) for c in coords.split(pairs)])
        im = (im.permute(0, 2, 3, 1) - mean) / std
        z = torch.as_tensor(np.stack(depth), dtype=torch.float32, device=device)
        field = F.interpolate(torch.rand((2 * pairs, 1, 8, 8), generator=gen, device=device),
                              size=(h, w), mode="bilinear", align_corners=False)[:, 0]
        cut = field.flatten(1).kthvalue(max(1, round(traffic["holes"] * h * w)), 1).values
        z = torch.where(field <= cut[:, None, None], 0.0, z)
        Ts = np.zeros((pairs, 4, 4))
        for i, g in enumerate(geo):
            Ts[i, :3, :3] = g["R"].T
            Ts[i, :3, 3] = -g["R"].T @ g["C"]
            Ts[i, 3, 3] = 1.0
        K = np.stack([g["K"] for g in geo]).astype(np.float32)
        im, z = im.cpu().numpy(), z.cpu().numpy()
        out.append({"im_A": im[:pairs], "im_B": im[pairs:], "im_A_depth": z[:pairs],
                    "im_B_depth": z[pairs:], "T_1to2": Ts.astype(np.float32), "K1": K,
                    "K2": K.copy()})
    return out
