"""SfM in PyTorch: the port of the JAX package's `sfm/` (tracks, pose
graph, bundle adjustment, reconstruction, trajectory metrics)."""

from roma_torch.sfm.tracks import TrackBuilder, Track
from roma_torch.sfm.pose_graph import rotation_averaging, translation_averaging
from roma_torch.sfm.bundle_adjust import (
    BAProblem,
    bundle_adjust,
    bundle_adjust_cg_device,
    bundle_adjust_device,
    make_distributed_ba_step,
    triangulate_tracks,
)
from roma_torch.sfm.metrics import align_umeyama, absolute_trajectory_error
