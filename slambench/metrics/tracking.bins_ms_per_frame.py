"""tracking.bins_ms_per_frame: the program's track.bins span (the initial
tracking bins and each rebinning episode, waits left out) over the window,
per tracked frame."""


def read(ctx):
    t = ctx["window"]["timings"]
    n = t.get("n_track")
    return 1000.0 * t["track.bins"] / n if n and "track.bins" in t else None
