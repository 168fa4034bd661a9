"""tracking.iters_per_frame: mean tracking iterations applied per window
frame (below the configured count when the early stop fires)."""


def read(ctx):
    it = ctx["window"]["track_iters"]
    return sum(it) / len(it) if it else None
