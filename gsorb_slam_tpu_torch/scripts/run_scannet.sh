#!/usr/bin/env bash
set -e
ROUNDS=${ROUNDS:-5}
DATA_ROOT=${DATA_ROOT:-datasets/Scannet}
for seq in scene0000_00 scene0059_00 scene0106_00 scene0169_00 scene0181_00 scene0207_00; do
  for r in $(seq 1 "$ROUNDS"); do
    python -m gsorb_slam_tpu_torch.apps.run_rgbd \
      --config configs/scannet.yaml \
      --dataset "$DATA_ROOT/$seq" --type scannet \
      --out "experiments/scannet_${seq}_r${r}" "$@"
  done
done
