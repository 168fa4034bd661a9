"""Gaussian model PLY checkpoint IO.

The port's own numpy copy of ``gsorb_slam_tpu/eval/ply.py``.

The reference's only checkpoint format (SURVEY.md §5): binary little-endian
PLY with float32 vertex properties ``x y z rgb_0 rgb_1 rgb_2 opacity
scale_0 scale_1 scale_2 rot_0 rot_1 rot_2 rot_3`` holding the RAW
(unactivated) parameters (``SavePly``/``ConstructListAttributes``
``src/Utils.cc:182-229``). ``scripts/replay.py`` reconstructs full rendering
from this file + a trajectory, so we keep the exact property names and
binary layout for drop-in compatibility.
"""

from __future__ import annotations

import numpy as np

PROPS = (
    ["x", "y", "z"]
    + [f"rgb_{i}" for i in range(3)]
    + ["opacity"]
    + [f"scale_{i}" for i in range(3)]
    + [f"rot_{i}" for i in range(4)]
)


def save_gaussian_ply(
    path: str,
    means: np.ndarray,
    rgb: np.ndarray,
    logit_opacities: np.ndarray,
    log_scales: np.ndarray,
    quats: np.ndarray,
    active: np.ndarray | None = None,
) -> int:
    """Write the map to GaussianModel.ply. Returns the vertex count."""
    means = np.asarray(means, np.float32)
    rgb = np.asarray(rgb, np.float32)
    op = np.asarray(logit_opacities, np.float32).reshape(-1, 1)
    sc = np.asarray(log_scales, np.float32)
    qt = np.asarray(quats, np.float32)
    if active is not None:
        keep = np.asarray(active, bool)
        means, rgb, op, sc, qt = means[keep], rgb[keep], op[keep], sc[keep], qt[keep]
    data = np.concatenate([means, rgb, op, sc, qt], axis=1).astype("<f4")
    n = data.shape[0]
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        + "".join(f"property float {p}\n" for p in PROPS)
        + "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(data.tobytes())
    return n


def load_gaussian_ply(path: str) -> dict[str, np.ndarray]:
    """Read a GaussianModel.ply (ours or the reference's) back into raw
    parameter arrays."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        assert magic == b"ply", "not a PLY file"
        fmt = f.readline().strip()
        assert b"binary_little_endian" in fmt, f"unsupported format: {fmt}"
        n = None
        props: list[str] = []
        while True:
            line = f.readline().strip()
            if line == b"end_header":
                break
            parts = line.split()
            if parts[0] == b"element" and parts[1] == b"vertex":
                n = int(parts[2])
            elif parts[0] == b"property":
                assert parts[1] == b"float", "only float32 properties supported"
                props.append(parts[2].decode())
        assert n is not None
        raw = np.frombuffer(f.read(n * len(props) * 4), dtype="<f4").reshape(
            n, len(props)
        )
    col = {p: raw[:, i] for i, p in enumerate(props)}
    return {
        "means": np.stack([col["x"], col["y"], col["z"]], -1),
        "rgb": np.stack([col[f"rgb_{i}"] for i in range(3)], -1),
        "logit_opacities": col["opacity"],
        "log_scales": np.stack([col[f"scale_{i}"] for i in range(3)], -1),
        "quats": np.stack([col[f"rot_{i}"] for i in range(4)], -1),
    }
