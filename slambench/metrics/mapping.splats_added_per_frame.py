"""mapping.splats_added_per_frame: the program's splats_added counter
(densify's adds) over the window, per mapped frame."""


def read(ctx):
    t = ctx["window"]["timings"]
    n = t.get("n_map")
    return t["splats_added"] / n if n and "splats_added" in t else None
