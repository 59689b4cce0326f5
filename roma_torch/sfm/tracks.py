"""Match-graph -> feature tracks (union-find over quantized keypoints).

Net-new subsystem (no reference counterpart — the reference stops at two-view
pose, SURVEY §2.5): pairwise dense-matcher correspondences are fused into
multi-view tracks by snapping keypoints to a sub-pixel grid per image and
union-finding across pairs. Tracks feed triangulation + bundle adjustment.

The port's copy of the JAX package's `sfm/tracks.py` (numpy, unchanged).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np


@dataclasses.dataclass
class Track:
    """One 3D feature: observations {image_id: (x_px, y_px)}."""

    obs: dict[int, tuple[float, float]]


class _UnionFind:
    def __init__(self):
        self.parent: dict[tuple, tuple] = {}

    def find(self, x):
        p = self.parent.setdefault(x, x)
        if p != x:
            p = self.parent[x] = self.find(p)
        return p

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


class TrackBuilder:
    """Accumulate pairwise matches, emit consistent tracks.

    Keypoints are quantized to `cell_px` cells per image so the same physical
    feature seen in several pairs merges into one node. Conflicting tracks
    (two different cells of one image in a track) are dropped — the standard
    consistency filter.
    """

    def __init__(self, cell_px: float = 4.0):
        self.cell = cell_px
        self.uf = _UnionFind()
        self.coords: dict[tuple[int, int, int], tuple[float, float, int]] = {}

    def _node(self, img: int, kpt) -> tuple[int, int, int]:
        cx = int(kpt[0] / self.cell)
        cy = int(kpt[1] / self.cell)
        key = (img, cx, cy)
        # running mean of observed positions in this cell
        if key in self.coords:
            x, y, n = self.coords[key]
            self.coords[key] = (
                (x * n + float(kpt[0])) / (n + 1),
                (y * n + float(kpt[1])) / (n + 1),
                n + 1,
            )
        else:
            self.coords[key] = (float(kpt[0]), float(kpt[1]), 1)
        return key

    def add_matches(self, img_i: int, img_j: int, kpts_i: np.ndarray, kpts_j: np.ndarray):
        for a, b in zip(np.asarray(kpts_i), np.asarray(kpts_j)):
            self.uf.union(self._node(img_i, a), self._node(img_j, b))

    def build(self, min_length: int = 2) -> list[Track]:
        groups: dict[tuple, list[tuple]] = defaultdict(list)
        for node in list(self.uf.parent):
            groups[self.uf.find(node)].append(node)
        tracks = []
        for nodes in groups.values():
            imgs = [n[0] for n in nodes]
            if len(set(imgs)) != len(imgs):
                continue  # inconsistent: one image twice
            if len(nodes) < min_length:
                continue
            obs = {n[0]: self.coords[n][:2] for n in nodes}
            tracks.append(Track(obs))
        return tracks
