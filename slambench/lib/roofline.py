"""The least time the card could take for the blends the System runs, from
work that the data needs, whatever implements it.

Peaks: NVIDIA's H100 SXM data sheet, 67 TFLOP/s float32 outside the tensor
cores and 3.35 TB/s of HBM (at the full 700 W power limit).

Work, per blend over a frame's tile lists (depth-sorted, as the
configuration's tiling builds them), counted by the reference
(``reference.render.pairs_to_last``):

- pairs: for each pixel, the list positions up to and including its last
  applied splat (those a front-to-back blend must evaluate, whatever it
  culls or how it walks them);
- a pair costs :data:`FWD_OPS` operations forward and :data:`BWD_OPS`
  backward (written out below from the equations), a tile instance
  :data:`PROJ_OPS` for its projection and its adjoint;
- bytes: each input read once and each output written once. Tracking
  reads the live splats' rows (:data:`ROW_BYTES`) and the frame's colour
  and depth (16 B a pixel), and writes a loss and a 7-float gradient;
  mapping reads the rows and the frame and writes a gradient row per
  splat.

Least time of an iteration = max(bytes / 3.35 TB/s, operations / 67
TFLOP/s).
"""

from __future__ import annotations

PEAK_FLOPS = 67e12  # float32, H100 SXM
PEAK_BYTES = 3.35e12  # HBM3, H100 SXM

# Forward, per (pixel, splat) pair: offsets 2; the conic quadratic 9
# (d0^2, d1^2, a d0^2, c d1^2, sum, x -0.5, d0 d1, b d0 d1, minus); exp 1;
# opacity product and clamp 2; T alpha, 1 - alpha, T (1 - alpha) 3; five
# accumulations (r, g, b, depth, alpha) as multiply-adds 10.
FWD_OPS = 27
# Backward, per pair: the forward's alpha again 14; the five channels'
# contributions to dL/dalpha 10; the transmittance recurrence 3;
# dalpha/dpower 2; dpower to the 2D mean and conic 10; six gradient
# accumulations as multiply-adds 12.
BWD_OPS = 51
# Per tile instance: the EWA projection (camera transform 18, Jacobian and
# 2D covariance 45, inverse 8, opacity 4) and its adjoint, about twice.
PROJ_OPS = 225
ROW_BYTES = 56  # means 3, rgb 3, quats 4, opacity 1, log-scales 3 float32
PIXEL_BYTES = 16  # colour 3 and depth 1 float32


def iteration_least_s(pairs: int, instances: int, n_rows: int, n_pixels: int,
                      write_rows: bool) -> float:
    """Least seconds of one forward + backward iteration."""
    ops = pairs * (FWD_OPS + BWD_OPS) + instances * PROJ_OPS
    nbytes = n_rows * ROW_BYTES * (2 if write_rows else 1) + n_pixels * PIXEL_BYTES
    return max(nbytes / PEAK_BYTES, ops / PEAK_FLOPS)
