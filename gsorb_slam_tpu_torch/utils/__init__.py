from gsorb_slam_tpu_torch.utils import drawing

__all__ = ["drawing"]
