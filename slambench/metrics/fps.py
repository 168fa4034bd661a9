"""fps: frames completed in the window / seconds from the window's start to
the end of its last frame (host clock; every frame ends in a device sync)."""


def read(ctx):
    w = ctx["window"]
    return w["frames"] / w["seconds"] if w["seconds"] > 0 else None
