#!/usr/bin/env bash
# Benchmark driver: 5 repetitions x TUM sequences (reference scripts/run_tum.sh), on the port.
set -e
ROUNDS=${ROUNDS:-5}
DATA_ROOT=${DATA_ROOT:-datasets/TUM_RGBD}
for seq in rgbd_dataset_freiburg1_desk rgbd_dataset_freiburg2_xyz rgbd_dataset_freiburg3_long_office_household; do
  for r in $(seq 1 "$ROUNDS"); do
    python -m gsorb_slam_tpu_torch.apps.run_rgbd \
      --config configs/tum1.yaml \
      --dataset "$DATA_ROOT/$seq" --type tum \
      --out "experiments/${seq}_r${r}" "$@"
  done
done
