"""system.frame_ms.p90: 90th percentile of the window's per-frame wall
times (host clock around track_rgbd, which ends in a device sync)."""

import numpy as np


def read(ctx):
    f = ctx["window"]["frame_s"]
    return 1000.0 * float(np.percentile(np.asarray(f, np.float64), 90)) if f else None
