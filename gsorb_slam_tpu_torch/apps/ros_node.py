"""ROS1 node driver (counterpart of ``gsorb_slam_tpu/apps/ros_node.py``, the
analog of the reference's ``Examples/ROS/ORB_SLAM2/src/`` nodes).

The reference's three thin nodes (``ros_rgbd.cc``, ``ros_mono.cc``,
``ros_stereo.cc``) subscribe to sensor_msgs/Image topics (RGB-D and stereo
pairs through an ApproximateTime synchronizer, ``ros_rgbd.cc:67-72``),
convert with cv_bridge, feed ``System::Track*`` with
``header.stamp.toSec()`` (``ros_rgbd.cc:112``) and save the trajectory at
shutdown. Here the logic that needs no ROS is plain functions:
:func:`decode_image` (the cv_bridge conversion of a duck-typed
sensor_msgs/Image: ``encoding``, ``height``, ``width``, ``step``,
``data``, ``is_bigendian``) and :class:`ApproxTimeSync` (nearest-timestamp
pairing of two streams within a window). :func:`main` imports rospy only
when it runs and exits with a message where ROS is absent. The System runs
on the card (``--cpu``: on the CPU).

Run (inside a ROS1 environment)::

    python -m gsorb_slam_tpu_torch.apps.ros_node --config tum1.yaml --sensor rgbd \\
        --rgb-topic /camera/rgb/image_raw \\
        --depth-topic /camera/depth_registered/image_raw
"""

from __future__ import annotations

import argparse
import collections
from typing import Callable

import numpy as np

# sensor_msgs/Image encodings -> (dtype, channels). Depth commonly arrives
# as 16UC1 (millimeters; scaled by DepthMapFactor like the file loaders) or
# 32FC1 (meters).
_ENCODINGS = {
    "rgb8": (np.uint8, 3),
    "bgr8": (np.uint8, 3),
    "rgba8": (np.uint8, 4),
    "bgra8": (np.uint8, 4),
    "mono8": (np.uint8, 1),
    "8UC1": (np.uint8, 1),
    "mono16": (np.uint16, 1),
    "16UC1": (np.uint16, 1),
    "32FC1": (np.float32, 1),
}


def decode_image(msg, depth_factor: float = 1.0) -> np.ndarray:
    """Convert a sensor_msgs/Image-shaped message into the array the
    ``System`` entry points take: color -> [H, W, 3] float32 in [0, 1]
    (RGB order), depth -> [H, W] float32 meters (``cv_bridge::toCvShare``
    + the ``DepthMapFactor`` conversion of ``src/Tracking.cc:275-276``).

    ``msg`` needs ``encoding``, ``height``, ``width``, ``step``, ``data``
    and (for multi-byte encodings) ``is_bigendian``.
    """
    enc = msg.encoding
    if enc not in _ENCODINGS:
        raise ValueError(f"unsupported image encoding {enc!r}")
    dtype, ch = _ENCODINGS[enc]
    itemsize = np.dtype(dtype).itemsize
    if getattr(msg, "is_bigendian", 0) and itemsize > 1:
        dtype = np.dtype(dtype).newbyteorder(">")
    # `step` is the row stride in BYTES; rows may be padded (and the pad
    # need not be a multiple of itemsize) — slice rows at the byte level.
    raw = np.frombuffer(bytes(msg.data), dtype=np.uint8)
    rows = raw.reshape(msg.height, msg.step)[:, : msg.width * ch * itemsize]
    img = np.ascontiguousarray(rows).view(dtype).reshape(
        msg.height, msg.width, ch
    )
    img = img if ch > 1 else img[..., 0]

    if enc in ("mono16", "16UC1", "32FC1"):  # depth
        d = img.astype(np.float32)
        if enc != "32FC1":
            d = d / float(depth_factor)
        return np.ascontiguousarray(d.reshape(msg.height, msg.width))

    if ch == 1:  # grayscale color stream -> replicate
        img = np.repeat(img[..., None], 3, axis=-1)
    elif enc.startswith("bgr"):
        img = img[..., 2::-1]  # BGR(A) -> RGB
    else:
        img = img[..., :3]
    return np.ascontiguousarray(img.astype(np.float32) / 255.0)


class ApproxTimeSync:
    """Two-stream nearest-timestamp pairing within ``max_dt`` seconds —
    the behavior of ``message_filters`` ApproximateTime for the 2-topic
    case the reference uses (``ros_rgbd.cc:70-72``). Messages are queued
    per stream (bounded) and the callback fires once per matched pair, in
    timestamp order, each message consumed at most once."""

    def __init__(self, callback: Callable, max_dt: float = 0.02, queue: int = 10):
        self.cb = callback
        self.max_dt = max_dt
        self.queues = (collections.deque(maxlen=queue),
                       collections.deque(maxlen=queue))

    def push(self, stream: int, stamp: float, msg) -> None:
        self.queues[stream].append((stamp, msg))
        self._drain()

    def _drain(self) -> None:
        qa, qb = self.queues
        while qa and qb:
            ta, _ = qa[0]
            tb, _ = qb[0]
            if abs(ta - tb) <= self.max_dt:
                _, ma = qa.popleft()
                _, mb = qb.popleft()
                self.cb(min(ta, tb), ma, mb)
            elif ta < tb:
                qa.popleft()  # unmatched: too old to ever pair
            else:
                qb.popleft()


def _stamp(msg) -> float:
    h = msg.header.stamp
    return float(h.secs) + float(h.nsecs) * 1e-9


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True, help="dataset YAML (reference schema)")
    ap.add_argument("--sensor", default="rgbd", choices=["rgbd", "mono", "stereo"])
    ap.add_argument("--rgb-topic", default="/camera/rgb/image_raw")
    ap.add_argument("--depth-topic", default="/camera/depth_registered/image_raw")
    ap.add_argument("--left-topic", default="/camera/left/image_raw")
    ap.add_argument("--right-topic", default="/camera/right/image_raw")
    ap.add_argument("--vocab", default=None, help="ORBvoc.txt for loop closing")
    ap.add_argument("--out", default="KeyFrameTrajectory.txt")
    ap.add_argument("--max-dt", type=float, default=0.02)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    args = ap.parse_args(argv)

    try:
        import rospy
        from sensor_msgs.msg import Image
    except ImportError:
        print("rospy not available: this driver needs a ROS1 environment "
              "(the file-based drivers are apps/run_{rgbd,mono,stereo}.py)")
        return 2

    from gsorb_slam_tpu_torch.core.config import load_config
    from gsorb_slam_tpu_torch.eval import trajectory as TRAJ
    from gsorb_slam_tpu_torch.slam.system import System

    cfg = load_config(args.config)
    vocab = None
    if args.vocab:
        from gsorb_slam_tpu_torch.frontend.vocab import load_orbvoc_text

        vocab = load_orbvoc_text(args.vocab)
    system = System(cfg, frontend="orb", vocabulary=vocab,
                    device="cpu" if args.cpu else "cuda")
    dmf = cfg.camera.depth_map_factor

    rospy.init_node("gsorb_slam_tpu", anonymous=True)

    if args.sensor == "rgbd":
        def on_pair(t, m_rgb, m_depth):
            system.track_rgbd(decode_image(m_rgb), decode_image(m_depth, dmf), t)

        sync = ApproxTimeSync(on_pair, max_dt=args.max_dt)
        rospy.Subscriber(args.rgb_topic, Image, lambda m: sync.push(0, _stamp(m), m),
                         queue_size=1)
        rospy.Subscriber(args.depth_topic, Image, lambda m: sync.push(1, _stamp(m), m),
                         queue_size=1)
    elif args.sensor == "stereo":
        def on_pair(t, m_l, m_r):
            system.track_stereo(decode_image(m_l), decode_image(m_r), t)

        sync = ApproxTimeSync(on_pair, max_dt=args.max_dt)
        rospy.Subscriber(args.left_topic, Image, lambda m: sync.push(0, _stamp(m), m),
                         queue_size=1)
        rospy.Subscriber(args.right_topic, Image, lambda m: sync.push(1, _stamp(m), m),
                         queue_size=1)
    else:
        rospy.Subscriber(args.rgb_topic, Image,
                         lambda m: system.track_monocular(decode_image(m), _stamp(m)),
                         queue_size=1)

    rospy.spin()

    TRAJ.save_tum(args.out, system.get_trajectory())
    print(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
