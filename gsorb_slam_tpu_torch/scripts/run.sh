#!/usr/bin/env bash
# Full benchmark sweep (reference run.sh), on the port.
here="$(dirname "$0")"
bash "$here/run_tum.sh" "$@"
bash "$here/run_replica.sh" "$@"
bash "$here/run_scannet.sh" "$@"
