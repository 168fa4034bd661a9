"""tracking.ms_per_iter: the System's tracking timer over the window, per
tracking iteration applied (FrameRecord.track_iters)."""


def read(ctx):
    w = ctx["window"]
    n = sum(w["track_iters"])
    return 1000.0 * w["timings"]["track"] / n if n else None
