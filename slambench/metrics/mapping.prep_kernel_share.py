"""mapping.prep_kernel_share: the program's map_prep_kernels counter (the
launches of the mapping iteration's hand-written adjoint of the splat
projection, K10b) over the window, per mapping iteration (n_map.iter), in
percent. A program without the counter reports nothing."""


def read(ctx):
    t = ctx["window"]["timings"]
    n = t.get("n_map.iter")
    if not n or "map_prep_kernels" not in t:
        return None
    return 100.0 * t["map_prep_kernels"] / n
