from gsorb_slam_tpu_torch.ops.losses import l1_tracking

__all__ = ["l1_tracking"]
