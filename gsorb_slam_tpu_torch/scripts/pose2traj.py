"""Convert ScanNet per-frame pose files into one groundtruth.txt
(counterpart of ``scripts/pose2traj.py``, the same output).

The reference's ``scripts/dataset_utils/pose2traj.sh`` cats ``pose/<i>.txt``
4x4 matrices into ``groundtruth.txt`` lines of ``<frame_id> <16 row-major
floats>``; evaluation tooling (``apps.eval_ate``) reads either repo's file.

Usage:
    python -m gsorb_slam_tpu_torch.scripts.pose2traj <scene_dir> [<scene_dir> ...]

where each <scene_dir> holds a ``pose/`` directory of ``<i>.txt`` files (one
4x4 camera-to-world matrix per frame, as the ScanNet reader exports them).
Writes ``<scene_dir>/groundtruth.txt``. Non-finite poses (ScanNet marks
untracked frames with -inf) are skipped, as ``slam.dataset.ScanNetDataset``
skips them.
"""

import os
import sys

import numpy as np


def convert_scene(scene_dir: str) -> int:
    pose_dir = os.path.join(scene_dir, "pose")
    if not os.path.isdir(pose_dir):
        raise FileNotFoundError(f"no pose/ directory under {scene_dir}")
    ids = sorted(
        int(os.path.splitext(f)[0])
        for f in os.listdir(pose_dir)
        if f.endswith(".txt")
    )
    out_path = os.path.join(scene_dir, "groundtruth.txt")
    n = 0
    with open(out_path, "w") as out:
        for i in ids:
            T = np.loadtxt(os.path.join(pose_dir, f"{i}.txt"), dtype=np.float64)
            if T.shape != (4, 4) or not np.all(np.isfinite(T)):
                continue
            vals = " ".join(f"{v:.6f}" for v in T.reshape(-1))
            out.write(f"{i} {vals}\n")
            n += 1
    return n


def main(argv) -> int:
    if not argv:
        print(__doc__)
        return 2
    for scene in argv:
        n = convert_scene(scene)
        print(f"{scene}: wrote {n} poses -> groundtruth.txt")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
