"""frontend.ms_per_frame: the System's ORB frontend and keyframe-chain
timers over the window, per window frame."""


def read(ctx):
    w = ctx["window"]
    t = w["timings"]
    return 1000.0 * (t["frontend"] + t["kf"]) / w["frames"] if w["frames"] else None
