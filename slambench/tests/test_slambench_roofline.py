"""The roofline's work counts depend on the data only: two different walks
over the same tile lists give the same (pixel, splat) pair count, and the
least time is the larger of the byte and operation bounds."""

import math

import torch

from slambench.lib import roofline
from slambench.reference import render as R


def tiny_map(n=300, seed=0) -> R.Splats:
    g = torch.Generator().manual_seed(seed)
    means = torch.stack([torch.rand(n, generator=g) * 1.2 - 0.6,
                         torch.rand(n, generator=g) * 0.9 - 0.45,
                         torch.rand(n, generator=g) * 1.5 + 1.0], 1)
    return R.Splats(means=means, rgb=torch.rand((n, 3), generator=g),
                    quats=torch.randn((n, 4), generator=g),
                    logit_opacities=torch.randn(n, generator=g) + 1.0,
                    log_scales=torch.log(torch.rand((n, 3), generator=g) * 0.03 + 0.01),
                    active=torch.ones(n, dtype=torch.bool))


def walk_pixel_by_pixel(sc: R.Screen, idx, counts, cam: R.Cam, tl: R.Tiling) -> int:
    """One pixel at a time, one list entry at a time, stopping where the
    transmittance rule stops: the list position of the last applied splat."""
    ty, tx = R.grid(cam, tl)
    total = 0
    for tile in range(ty * tx):
        ox, oy = (tile % tx) * tl.tile, (tile // tx) * tl.tile
        lst = idx[tile, : int(counts[tile])].tolist()
        for py in range(tl.tile):
            for px in range(tl.tile):
                u, v = float(ox + px), float(oy + py)
                T, last = 1.0, 0
                for k, gid in enumerate(lst):
                    if not bool(sc.valid[gid]):
                        continue
                    a, b, c = (float(x) for x in sc.conic[gid])
                    d0 = float(sc.mean2d[gid, 0]) - u
                    d1 = float(sc.mean2d[gid, 1]) - v
                    power = -0.5 * (a * d0 * d0 + c * d1 * d1) - b * d0 * d1
                    alpha = min(0.99, float(sc.opacity[gid]) * math.exp(power))
                    if power > 0 or alpha < R.MIN_ALPHA:
                        continue
                    if T < R.STOP_T:
                        break
                    last = k + 1
                    T *= 1.0 - alpha
                total += last
    return total


def test_pair_count_is_the_same_for_two_walks():
    cam = R.Cam(fx=40.0, fy=40.0, cx=23.5, cy=15.5, width=48, height=32)
    tl = R.Tiling(tile=16, capacity=256, max_dup=16, dilate_px=0.0)
    s = tiny_map()
    T = torch.eye(4)
    pairs, inst = R.pairs_to_last(s, T, cam, tl, crossing=False)
    sc = R.project(s, T, cam)
    idx, counts = R.tile_lists(sc, cam, tl)
    assert inst == int(counts.sum()) > 0
    assert pairs == walk_pixel_by_pixel(sc, idx, counts, cam, tl)
    assert pairs > 0


def test_least_time_is_the_larger_bound():
    # Operation-bound: many pairs, few bytes.
    t = roofline.iteration_least_s(10**9, 0, 10, 10, write_rows=False)
    assert math.isclose(t, 10**9 * (roofline.FWD_OPS + roofline.BWD_OPS) / roofline.PEAK_FLOPS)
    # Byte-bound: no pairs.
    t = roofline.iteration_least_s(0, 0, 1000, 1000, write_rows=True)
    assert math.isclose(t, (1000 * 2 * roofline.ROW_BYTES + 1000 * roofline.PIXEL_BYTES)
                        / roofline.PEAK_BYTES)
