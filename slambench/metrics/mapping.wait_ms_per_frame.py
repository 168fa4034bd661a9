"""mapping.wait_ms_per_frame: the program's map.wait span (the host
blocked on the card inside the map phase, the closing sync included) over
the window, per mapped frame."""


def read(ctx):
    t = ctx["window"]["timings"]
    n = t.get("n_map")
    return 1000.0 * t["map.wait"] / n if n and "map.wait" in t else None
