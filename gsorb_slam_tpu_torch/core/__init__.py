from gsorb_slam_tpu_torch.core import camera, config, transforms

__all__ = ["camera", "config", "transforms"]
