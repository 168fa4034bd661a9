from gsorb_slam_tpu_torch.splat.gaussians import (
    GaussianMap,
    PoseState,
    add_points,
    empty_map,
    init_pose_state,
    pose_adam_step,
    prefix_view,
    single_pixel_log_scale,
)

__all__ = [
    "GaussianMap",
    "PoseState",
    "add_points",
    "empty_map",
    "init_pose_state",
    "pose_adam_step",
    "prefix_view",
    "single_pixel_log_scale",
]
