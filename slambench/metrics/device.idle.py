"""device.idle: 1 - (union of kernel intervals / wall) over the profiled
frames, in percent."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
