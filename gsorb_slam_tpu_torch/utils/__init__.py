from gsorb_slam_tpu_torch.utils import drawing, trace

__all__ = ["drawing", "trace"]
