#!/usr/bin/env bash
# The runs that set a cell's bounds and limits, on the card, in one call:
#
#     bash slambench/tools/measure.sh <cell> <seed base> [out dir] [parts]
#
# parts (default "sets traced control faults"):
#   sets     two sets of 6 full-length runs with the same seeds (base+1 ..
#            base+6); their spreads set the end-to-end bounds;
#   traced   3 traced runs (base+11 .. base+13);
#   control  3 runs with --control on fresh seeds (base+21 .. base+23): the
#            TF32 control's numbers judged against the cell's limits beside
#            the program's;
#   faults   each fault of slambench/lib/faults.py that the cell's sensor
#            can have, planted once (seed base+31), at the cell's own size.
# Each run's standard output and error go to <out dir>/<cell>/<tag>.{out,err}
# (default chiprun_out); a summary per run goes to standard output.
set -u
cell=$1
base=$2
out=${3:-chiprun_out}/$cell
parts=${4:-sets traced control faults}
seconds=$(python3 -c 'import json; print(json.load(open("BENCHMARK.json"))["run_seconds"])')
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run() {
  tag=$1
  shift
  s0=$SECONDS
  python3 slambench/run.py "$@" > "$out/$tag.out" 2> "$out/$tag.err"
  echo "$tag rc=$? wall=$((SECONDS - s0))"
  grep -E "^(check numbers|control|window|frames)" "$out/$tag.err" | cut -c1-1500
  tail -1 "$out/$tag.out" | cut -c1-600
}
for part in $parts; do
  case $part in
    sets)
      for set in a b; do
        for k in 1 2 3 4 5 6; do
          run "set$set$k" --workload "$cell" --seed $((base + k)) --seconds "$seconds" --trace 0
        done
      done ;;
    traced)
      for k in 1 2 3; do
        run "trace$k" --workload "$cell" --seed $((base + 10 + k)) --seconds "$seconds" --trace 1
      done ;;
    control)
      for k in 1 2 3; do
        run "control$k" --workload "$cell" --seed $((base + 20 + k)) --seconds 5 --trace 0 \
          --control
      done ;;
    faults)
      faults=$(python3 -c 'import sys; sys.path.insert(0, ".")
from pathlib import Path
from slambench.lib import catalog
from slambench.lib.faults import faults_for
from slambench.lib.sequence import sensor_of
cell = catalog.workload(catalog.load_benchmark(Path(".")), sys.argv[1])
print(" ".join(faults_for(sensor_of(catalog.config(Path("."), cell["config"])))))' "$cell")
      for f in $faults; do
        run "fault_$f" --workload "$cell" --seed $((base + 31)) --seconds 5 --trace 0 --fault "$f"
      done ;;
  esac
done
