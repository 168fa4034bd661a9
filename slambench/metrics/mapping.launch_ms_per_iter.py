"""mapping.launch_ms_per_iter: the program's map.iter span (the host
issuing each mapping iteration, waits left out) over the window, per
iteration."""


def read(ctx):
    t = ctx["window"]["timings"]
    n = t.get("n_map.iter")
    return 1000.0 * t["map.iter"] / n if n else None
