"""mapping.ms_per_frame: the System's map timer (prune, render, densify,
window, map_window) over the window, per mapped frame."""


def read(ctx):
    t = ctx["window"]["timings"]
    return 1000.0 * t["map"] / t["n_map"] if t["n_map"] else None
