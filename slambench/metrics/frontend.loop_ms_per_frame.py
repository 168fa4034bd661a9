"""frontend.loop_ms_per_frame: the program's kf.loop span (the loop
closer's whole turn per keyframe: detection, and a closure's correction,
fusion and global BA) over the window, per window frame."""


def read(ctx):
    w = ctx["window"]
    t = w["timings"]
    return 1000.0 * t["kf.loop"] / w["frames"] if w["frames"] and "kf.loop" in t else None
