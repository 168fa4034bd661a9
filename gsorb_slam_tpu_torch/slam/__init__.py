from gsorb_slam_tpu_torch.slam.mapping import (
    WindowFrames,
    build_window_frames,
    densify_frame,
    map_step,
    map_window,
    prune_map,
    seed_from_frame,
    window_chunk_budget,
)
from gsorb_slam_tpu_torch.slam.tracking import (
    FeatureMatches,
    TrackResult,
    reprojection_chi2,
    track_frame,
    tracking_raster_config,
)

__all__ = [
    "FeatureMatches",
    "TrackResult",
    "WindowFrames",
    "build_window_frames",
    "densify_frame",
    "map_step",
    "map_window",
    "prune_map",
    "reprojection_chi2",
    "seed_from_frame",
    "track_frame",
    "tracking_raster_config",
    "window_chunk_budget",
]
