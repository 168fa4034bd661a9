"""The repository's tools, ported: ``train_vocab``, ``make_tum_disk``,
``pose2traj``, ``debug_loop`` (each ``python -m
gsorb_slam_tpu_torch.scripts.<name>``) and the shell drivers ``run.sh``,
``run_tum.sh``, ``run_replica.sh`` and ``run_scannet.sh``."""
