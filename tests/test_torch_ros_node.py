"""The port's ROS node helpers against the JAX package's (mirrors
``tests/test_ros_node.py``): ``decode_image`` gives arrays equal to the JAX
function's on the same sensor_msgs/Image-shaped messages (rgb8, bgr8,
rgba8, bgra8, mono8, 16UC1 with row padding little- and big-endian, 32FC1),
``ApproxTimeSync`` fires the same pairs in the same order on the same
pushes, and ``main`` without rospy exits with the JAX node's message.
"""

import sys
import types

import numpy as np
import pytest

from gsorb_slam_tpu.apps import ros_node as JR
from gsorb_slam_tpu_torch.apps import ros_node as TR


def _msg(arr: np.ndarray, encoding: str, pad: int = 0, bigendian: bool = False):
    h, w = arr.shape[:2]
    ch = arr.shape[2] if arr.ndim == 3 else 1
    if bigendian:
        arr = arr.astype(arr.dtype.newbyteorder(">"))
    step = w * ch * arr.dtype.itemsize + pad
    data = b"".join(arr[r].tobytes() + b"\x00" * pad for r in range(h))
    return types.SimpleNamespace(encoding=encoding, height=h, width=w, step=step, data=data,
                                 is_bigendian=int(bigendian))


def _cases():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (4, 6, 3), np.uint8)
    rgba = rng.integers(0, 256, (3, 5, 4), np.uint8)
    d_mm = np.array([[0, 1000, 2500], [5000, 123, 65535]], np.uint16)
    return [
        ("rgb8", _msg(img, "rgb8"), 1.0),
        ("bgr8", _msg(img[..., ::-1].copy(), "bgr8"), 1.0),
        ("rgba8", _msg(rgba, "rgba8", pad=2), 1.0),
        ("bgra8", _msg(rgba, "bgra8"), 1.0),
        ("mono8", _msg(img[..., 0].copy(), "mono8", pad=1), 1.0),
        ("16UC1 padded", _msg(d_mm, "16UC1", pad=3), 5000.0),
        ("16UC1 big-endian", _msg(d_mm, "16UC1", pad=1, bigendian=True), 5000.0),
        ("32FC1", _msg(np.array([[0.5, 1.25]], np.float32), "32FC1"), 5000.0),
    ]


@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
def test_decode_image_matches_jax(case):
    _, msg, factor = case
    out, ref = TR.decode_image(msg, factor), JR.decode_image(msg, factor)
    assert out.dtype == ref.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)
    with pytest.raises(ValueError, match="unsupported"):
        TR.decode_image(types.SimpleNamespace(**{**vars(msg), "encoding": "yuv422"}))


@pytest.mark.parametrize("max_dt", [0.01, 0.02])
def test_approx_time_sync_matches_jax(max_dt):
    rng = np.random.default_rng(1)
    pushes = []
    for k in range(40):  # two cameras at 30 Hz with jitter, drops and reordering
        frame = [(s, round(k / 30 + float(rng.uniform(-0.012, 0.012)), 5), f"m{s}_{k}")
                 for s in (0, 1) if rng.uniform() > 0.15]
        pushes += [frame[i] for i in rng.permutation(len(frame))]
    got, ref = [], []
    sync_t = TR.ApproxTimeSync(lambda *a: got.append(a), max_dt=max_dt, queue=4)
    sync_j = JR.ApproxTimeSync(lambda *a: ref.append(a), max_dt=max_dt, queue=4)
    for s, stamp, m in pushes:
        sync_t.push(s, stamp, m)
        sync_j.push(s, stamp, m)
    assert got == ref and len(got) > 5


def test_stamp_and_main_without_rospy(monkeypatch, capsys):
    msg = types.SimpleNamespace(header=types.SimpleNamespace(
        stamp=types.SimpleNamespace(secs=1305031102, nsecs=175304000)))
    assert TR._stamp(msg) == JR._stamp(msg)
    monkeypatch.setitem(sys.modules, "rospy", None)  # import rospy raises ImportError
    assert TR.main(["--config", "configs/tum1.yaml", "--sensor", "stereo"]) == 2
    out = capsys.readouterr().out
    assert out.startswith("rospy not available: this driver needs a ROS1 environment")
