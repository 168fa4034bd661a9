"""tracking.wait_ms_per_iter: the program's track.wait span (the host
blocked on the card inside the tracking layer: the early-stop reads, the
tracked pose) over the window, per tracking iteration."""


def read(ctx):
    t = ctx["window"]["timings"]
    n = t.get("n_track.iter")
    return 1000.0 * t["track.wait"] / n if n and "track.wait" in t else None
