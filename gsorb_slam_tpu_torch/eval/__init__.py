from gsorb_slam_tpu_torch.eval import ate, evaluate, ply, trajectory

__all__ = ["ate", "evaluate", "ply", "trajectory"]
