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
    "reprojection_chi2",
    "track_frame",
    "tracking_raster_config",
]
