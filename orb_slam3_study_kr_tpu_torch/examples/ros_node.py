"""ROS node over the SLAM session.

Counterpart of the reference package's ``examples/ros_node.py`` (the
reference's ROS examples ros_mono.cc, ros_mono_inertial.cc, ros_stereo.cc,
ros_stereo_inertial.cc, ros_rgbd.cc): topic-driven front ends that decode
sensor_msgs images and IMU samples and feed them into the session.

The message core (``SlamNode``, ``decode_image``, ``stamp_to_sec``) is plain
Python over numpy and runs without ROS (the tests drive it with fake
messages).  ``main()`` needs ``rospy``; without it, it says so and returns 2.

    rosrun <pkg> ros_node.py --sensor mono-inertial --settings EuRoC.yaml \\
        --image /cam0/image_raw --imu /imu0 [--device cuda|cpu]
"""

import argparse
import sys

import numpy as np


def decode_image(msg):
    """sensor_msgs/Image -> grayscale float32 numpy (cv_bridge's role in the
    reference nodes)."""
    h, w = int(msg.height), int(msg.width)
    buf = np.frombuffer(bytearray(msg.data), np.uint8)
    enc = msg.encoding.lower()
    if enc in ("mono8", "8uc1"):
        img = buf.reshape(h, msg.step)[:, :w]
    elif enc in ("bgr8", "rgb8"):
        img = buf.reshape(h, msg.step)[:, : 3 * w].reshape(h, w, 3)
        # ITU-R BT.601 luma, with the weights in each encoding's order.
        wgt = (0.114, 0.587, 0.299) if enc == "bgr8" else (0.299, 0.587, 0.114)
        img = (img[..., 0] * wgt[0] + img[..., 1] * wgt[1]
               + img[..., 2] * wgt[2])
    elif enc in ("mono16", "16uc1"):
        dt = np.dtype(np.uint16)
        if getattr(msg, "is_bigendian", 0):
            dt = dt.newbyteorder(">")
        img = buf.view(dt).reshape(h, msg.step // 2)[:, :w]
    else:
        raise ValueError(f"unsupported image encoding: {msg.encoding}")
    return np.asarray(img, np.float32)


def stamp_to_sec(stamp):
    return float(stamp.secs) + 1e-9 * float(stamp.nsecs)


class SlamNode:
    """The topic-message core shared by every sensor configuration.  IMU
    samples are queued and drained per image, as the reference's
    ImuGrabber / SyncWithImu do."""

    def __init__(self, slam, sensor: str, imu_freq: float = 200.0,
                 depth_factor: float = 1000.0):
        self.slam = slam
        self.sensor = sensor
        self.inertial = sensor.endswith("-inertial")
        self.imu_freq = imu_freq
        # A raw ROS depth topic is usually mono16 millimetres; the session
        # takes metric depth, so divide by DepthMapFactor as the reference
        # does (Tracking.cc imDepth.convertTo(1/mDepthMapFactor)).
        self.depth_factor = float(depth_factor)
        self._imu = []          # (t, ax, ay, az, gx, gy, gz)
        self._last_t = None
        self.n_frames = 0

    # -- subscribers ---------------------------------------------------
    def on_imu(self, msg):
        self._imu.append((
            stamp_to_sec(msg.header.stamp),
            float(msg.linear_acceleration.x),
            float(msg.linear_acceleration.y),
            float(msg.linear_acceleration.z),
            float(msg.angular_velocity.x),
            float(msg.angular_velocity.y),
            float(msg.angular_velocity.z),
        ))

    def _drain_imu(self, ts):
        """IMU rows [dt, acc, gyro] in (t_prev, ts] (the tracker's
        preintegration window); None for a visual sensor."""
        if not self.inertial:
            return None
        t0 = self._last_t if self._last_t is not None \
            else ts - 1.0 / self.imu_freq
        rows = [r for r in self._imu if t0 < r[0] <= ts]
        self._imu = [r for r in self._imu if r[0] > ts]
        if not rows:
            return np.zeros((0, 7), np.float32)
        t_arr = np.asarray([r[0] for r in rows])
        dts = np.diff(np.concatenate([[t0], t_arr]))
        acc = np.asarray([r[1:4] for r in rows])
        gyro = np.asarray([r[4:7] for r in rows])
        return np.concatenate(
            [dts[:, None], acc, gyro], axis=1).astype(np.float32)

    def on_image(self, msg):
        ts = stamp_to_sec(msg.header.stamp)
        img = decode_image(msg)
        imu = self._drain_imu(ts)
        if self.sensor.startswith("stereo"):
            raise RuntimeError("stereo uses on_stereo(left, right)")
        self.slam.track_monocular(img, ts, imu=imu)
        self._last_t = ts
        self.n_frames += 1

    def on_stereo(self, msg_l, msg_r):
        ts = stamp_to_sec(msg_l.header.stamp)
        imu = self._drain_imu(ts)
        img_l, img_r = decode_image(msg_l), decode_image(msg_r)
        rect = getattr(self.slam, "rectifier", None)
        if rect is not None:
            # build_system gave the session the RECTIFIED geometry of a raw
            # distorted rig: feed it rectified pixels, as run_sequence does.
            img_l = rect.remap_left(img_l)
            img_r = rect.remap_right(img_r)
        self.slam.track_stereo(img_l, img_r, ts, imu=imu)
        self._last_t = ts
        self.n_frames += 1

    def on_rgbd(self, msg_rgb, msg_depth):
        ts = stamp_to_sec(msg_rgb.header.stamp)
        depth = decode_image(msg_depth)
        if self.depth_factor not in (0.0, 1.0):
            depth = depth / self.depth_factor
        imu = self._drain_imu(ts)
        self.slam.track_rgbd(decode_image(msg_rgb), depth, ts, imu=imu)
        self._last_t = ts
        self.n_frames += 1


def main(argv=None):
    try:
        import message_filters
        import rospy
        from sensor_msgs.msg import Image, Imu
    except ImportError:
        print("rospy is not installed; the SlamNode core is importable and "
              "tested, but running the node needs a ROS environment.",
              file=sys.stderr)
        return 2

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sensor", default="mono",
                    choices=["mono", "mono-inertial", "stereo",
                             "stereo-inertial", "rgbd"])
    ap.add_argument("--settings", required=True)
    ap.add_argument("--image", default="/camera/image_raw")
    ap.add_argument("--image-right", default="/camera/right/image_raw")
    ap.add_argument("--depth", default="/camera/depth/image_raw")
    ap.add_argument("--imu", default="/imu")
    ap.add_argument("--out", default="trajectory_tum.txt")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from orb_slam3_study_kr_tpu_torch.examples.run_euroc import build_system
    args.vocabulary = None
    slam = build_system(args)
    node = SlamNode(slam, args.sensor, imu_freq=float(slam.cfg.imu_freq))

    rospy.init_node("orb_slam3_torch", anonymous=True)
    if args.sensor.endswith("-inertial"):
        rospy.Subscriber(args.imu, Imu, node.on_imu, queue_size=1000)
    if args.sensor.startswith("stereo"):
        subs = [message_filters.Subscriber(args.image, Image),
                message_filters.Subscriber(args.image_right, Image)]
        sync = message_filters.ApproximateTimeSynchronizer(subs, 10, 0.005)
        sync.registerCallback(node.on_stereo)
    elif args.sensor == "rgbd":
        subs = [message_filters.Subscriber(args.image, Image),
                message_filters.Subscriber(args.depth, Image)]
        sync = message_filters.ApproximateTimeSynchronizer(subs, 10, 0.02)
        sync.registerCallback(node.on_rgbd)
    else:
        rospy.Subscriber(args.image, Image, node.on_image, queue_size=10)
    rospy.spin()
    slam.save_trajectory_tum(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
