"""tracking.launch_ms_per_iter: the program's track.iter span (the host
issuing each tracking iteration, its waits left out) over the window, per
iteration."""


def read(ctx):
    t = ctx["window"]["timings"]
    n = t.get("n_track.iter")
    return 1000.0 * t["track.iter"] / n if n else None
