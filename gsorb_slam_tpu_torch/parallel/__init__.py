from gsorb_slam_tpu_torch.parallel.mesh import (
    VIEW_AXIS,
    Mesh,
    make_mesh,
    parallel_window_step,
    replicate_map,
    shard_frames,
    window_pack_aux,
)
from gsorb_slam_tpu_torch.parallel.tracking import parallel_track_frame, strided_tile_perm

__all__ = [
    "VIEW_AXIS",
    "Mesh",
    "make_mesh",
    "parallel_track_frame",
    "parallel_window_step",
    "replicate_map",
    "shard_frames",
    "strided_tile_perm",
    "window_pack_aux",
]
