"""kernels.map_roofline: least time of the profiled frames' mapping
iterations (slambench.lib.roofline) / the device time of the kernels
launched inside the slambench.map_window ranges, in percent."""


def read(ctx):
    tr, rl = ctx["trace"], ctx["roofline"]
    if tr is None or not rl.get("map_least_s"):
        return None
    dev = tr.kernel_s_by_range.get("slambench.map_window", 0.0)
    return 100.0 * rl["map_least_s"] / dev if dev > 0 else None
