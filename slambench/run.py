#!/usr/bin/env python3
"""The benchmark of ``gsorb_slam_tpu_torch`` (the PyTorch + CUDA port of
GSORB-SLAM): one run of one cell.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``) names a
configuration (``slambench/configs/<config>.json``: the settings passed to
``System``) and a traffic mix (``slambench/traffic/<traffic>.json``: the
scene, the camera path, the shake and the sensor); the check's limits are
in ``slambench/limits/<cell>.json`` and each metric is read by
``slambench/metrics/<metric>.py``. Adding a cell or a metric adds files.

A run: generate the sequence on the card from the seed (uint8 colour and
uint16 depth on the host; a stereo configuration, ``"sensor": "stereo"``,
adds the right view), build ``System(config, frontend="orb")``, run the
warm-up frames (frame 0's initialisation and one frame), then feed whole
frames through ``System.track_rgbd`` (``System.track_stereo`` on a stereo
configuration) for ``--seconds`` (upload and conversion included); the
frame that crosses the mark is finished and counted. The run then goes on, untimed, until the ``eval_frames`` prefix
is done, for ATE and PSNR. With ``--trace 1`` it then profiles
``profiled_frames`` more frames. After the card's peak memory is read and
the System is freed, the plain reference checks what the timed path
produced (``slambench.lib.correctness``).

The last line of standard output is the result (JSON: ``attempted`` is
the window's frames, ``failed`` those whose returned pose was not finite);
the compared numbers and their limits are the last lines of standard
error and the result's last key, ``checks``. It exits 2 without a card.
``--control`` (the TF32 control in the program's place, judged beside the
program) and ``--fault <name>`` (a fault of ``slambench/lib/faults.py``
planted under the timed path) are runs for setting the check's limits
(``slambench/tools/measure.sh``), never benchmark runs.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HOST_THREADS = 4  # torch's intra-op pool and OpenMP / MKL / OpenBLAS
for _k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_k] = str(HOST_THREADS)
# Build and kernel caches at fixed paths inside the checkout (the port's own
# kernel library is built into build/kernels/ beside its package).
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["USE_FLAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def host_report() -> None:
    """CPU model, cores and the card's clocks and power, on earlier lines."""
    model = "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    log(f"host: cpu={model!r} nproc={os.cpu_count()} threads={HOST_THREADS}")
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.mem,power.draw,power.limit,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        log("nvidia-smi: " + out.stdout.strip())
    except (OSError, subprocess.SubprocessError) as e:
        log(f"nvidia-smi: unavailable ({e})")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="print the lower-precision control's numbers (TF32 reference in the "
                         "program's place) beside the program's; not a benchmark run")
    ap.add_argument("--fault", default=None,
                    help="plant a fault of slambench/lib/faults.py under the timed path and "
                         "show that the check catches it; not a benchmark run")
    args = ap.parse_args(argv)

    import torch

    from slambench.lib import catalog

    bench = catalog.load_benchmark(ROOT)
    cell = catalog.workload(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"no CUDA device for {args.workload} (available={torch.cuda.is_available()}, "
            f"count={torch.cuda.device_count() if torch.cuda.is_available() else 0}, "
            f"needs {cell['chips']}): the benchmark runs only on the card")
        return 2
    torch.set_num_threads(HOST_THREADS)
    host_report()
    from slambench.lib.harness import forbidden_modules, run_cell

    if args.fault:
        from slambench.lib.faults import FAULTS

        FAULTS[args.fault](setattr)
        log(f"fault planted: {args.fault}")

    result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                      device=torch.device("cuda"), control=args.control, t_process=T_PROCESS)
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded in this process: {found}")
        return 3
    checks = result["checks"]
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
