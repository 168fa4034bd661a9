"""kernels.track_roofline: least time of the profiled frames' tracking
iterations (slambench.lib.roofline) / the device time of the kernels
launched inside the slambench.track ranges, in percent."""


def read(ctx):
    tr, rl = ctx["trace"], ctx["roofline"]
    if tr is None or not rl.get("track_least_s"):
        return None
    dev = tr.kernel_s_by_range.get("slambench.track", 0.0)
    return 100.0 * rl["track_least_s"] / dev if dev > 0 else None
