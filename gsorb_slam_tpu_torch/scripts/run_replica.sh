#!/usr/bin/env bash
set -e
ROUNDS=${ROUNDS:-5}
DATA_ROOT=${DATA_ROOT:-datasets/Replica}
for seq in room0 room1 room2 office0 office1 office2 office3 office4; do
  for r in $(seq 1 "$ROUNDS"); do
    python -m gsorb_slam_tpu_torch.apps.run_rgbd \
      --config configs/replica.yaml \
      --dataset "$DATA_ROOT/$seq" --type replica \
      --out "experiments/replica_${seq}_r${r}" "$@"
  done
done
