"""End-to-end multi-view reconstruction: dense matching -> pose graph ->
tracks -> triangulation -> bundle adjustment.

The port of the JAX package's `sfm/reconstruction.py`: pairwise matches
feed two-view E-RANSAC (`roma_torch.estimation.essential.estimate_pose`);
global rotations/translations come from averaging; tracks are fused and
triangulated; the host-driver Schur-complement BA polishes, its blocks on
`device` (default: the GPU).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from roma_torch.device import resolve_device
from roma_torch.estimation.essential import estimate_pose
from roma_torch.sfm.bundle_adjust import (
    BAProblem,
    bundle_adjust,
    rodrigues,
    triangulate_tracks,
)
from roma_torch.sfm.pose_graph import (
    centers_to_translations,
    rotation_averaging,
    translation_averaging,
)
from roma_torch.sfm.tracks import TrackBuilder


@dataclasses.dataclass
class Reconstruction:
    rotations: np.ndarray      # (n, 3, 3) world2cam
    translations: np.ndarray   # (n, 3)
    points: np.ndarray         # (m, 3)
    cost: float
    # wall seconds by stage: "pose", "averaging", "tracks", "ba"
    timings: dict = dataclasses.field(default_factory=dict)

    @property
    def centers(self) -> np.ndarray:
        return -np.einsum("nji,nj->ni", self.rotations, self.translations)


def _rvec_from_R(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle (numerically safe log map)."""
    cos = np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)
    theta = np.arccos(cos)
    if theta < 1e-8:
        return np.zeros(3)
    w = (
        np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        / (2 * np.sin(theta))
    )
    return w * theta


def reconstruct(
    matches: dict[tuple[int, int], tuple[np.ndarray, np.ndarray]],
    intrinsics: np.ndarray,
    n_images: int,
    ransac_thresh: float = 1e-3,
    ba_iters: int = 25,
    cell_px: float = 4.0,
    min_track_length: int = 2,
    rng: np.random.Generator | None = None,
    device=None,
) -> Reconstruction:
    """matches: {(i, j): (kpts_i px (N,2), kpts_j px (N,2))} pairwise
    correspondences (from `matcher.match` + `sample` + pixel conversion).
    intrinsics: (n_images, 3, 3). Returns the refined reconstruction
    (gauge: camera 0 at identity, unit-ish baseline scale)."""
    dev = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    timings = {}

    # two-view geometry on every matched pair
    t0 = time.perf_counter()
    edges_R, edges_t = [], []
    tb = TrackBuilder(cell_px=cell_px)
    inliers = []
    for (i, j), (ki, kj) in matches.items():
        ret = estimate_pose(ki, kj, intrinsics[i], intrinsics[j], ransac_thresh, rng=rng)
        if ret is None:
            continue
        R_ij, t_ij, inl = ret
        edges_R.append((i, j, R_ij))
        edges_t.append((i, j, t_ij[:, 0]))
        inliers.append((i, j, ki[inl], kj[inl]))
    timings["pose"] = time.perf_counter() - t0

    if not edges_R:
        raise ValueError("no usable two-view geometries")

    # global initialization
    t0 = time.perf_counter()
    Rs = rotation_averaging(n_images, edges_R)
    centers = translation_averaging(n_images, Rs, edges_t)
    ts = centers_to_translations(Rs, centers)
    timings["averaging"] = time.perf_counter() - t0

    # tracks -> observation table
    t0 = time.perf_counter()
    for i, j, ki, kj in inliers:
        tb.add_matches(i, j, ki, kj)
    tracks = tb.build(min_length=min_track_length)
    cam_idx, pt_idx, uv = [], [], []
    for p, tr in enumerate(tracks):
        for img, xy in tr.obs.items():
            cam_idx.append(img)
            pt_idx.append(p)
            uv.append(xy)
    cam_idx = np.asarray(cam_idx, np.int32)
    pt_idx = np.asarray(pt_idx, np.int32)
    uv = np.asarray(uv, np.float32)
    timings["tracks"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cameras = np.concatenate(
        [np.stack([_rvec_from_R(R) for R in Rs]), ts], axis=-1
    ).astype(np.float32)
    X0 = triangulate_tracks(cameras, intrinsics, cam_idx, pt_idx, uv, len(tracks), device=dev)
    problem = BAProblem.from_arrays(cameras, X0.astype(np.float32),
                                    intrinsics.astype(np.float32), cam_idx, pt_idx, uv,
                                    device=dev)
    # badly-triangulated observations (behind a camera / reprojection error
    # beyond 32 px at init) are mask-gated out and periodically re-admitted
    problem, cost = bundle_adjust(problem, iters=ba_iters, huber_delta=4.0, max_err_px=32.0)
    cams = problem.cameras
    Rs_out = rodrigues(cams[:, :3]).cpu().numpy()
    cams = cams.cpu().numpy()
    points = problem.points.cpu().numpy()
    timings["ba"] = time.perf_counter() - t0
    return Reconstruction(rotations=Rs_out, translations=cams[:, 3:], points=points, cost=cost,
                          timings=timings)
