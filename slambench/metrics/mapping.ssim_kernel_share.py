"""mapping.ssim_kernel_share: the program's map_ssim_kernels counter (the
launches of the mapping loss's hand-written SSIM adjoint, K11b) over the
window, per mapping iteration (n_map.iter), in percent. A program without
the counter reports nothing."""


def read(ctx):
    t = ctx["window"]["timings"]
    n = t.get("n_map.iter")
    if not n or "map_ssim_kernels" not in t:
        return None
    return 100.0 * t["map_ssim_kernels"] / n
