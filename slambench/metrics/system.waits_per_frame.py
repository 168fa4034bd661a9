"""system.waits_per_frame: the program's blocking reads of the card (its
<layer>.wait spans: frame, frontend, track, kf, map) over the window, per
window frame."""

LAYERS = ("frame", "frontend", "track", "kf", "map")


def read(ctx):
    w = ctx["window"]
    t = w["timings"]
    keys = [f"n_{layer}.wait" for layer in LAYERS]
    if not w["frames"] or any(k not in t for k in keys):
        return None
    return sum(t[k] for k in keys) / w["frames"]
