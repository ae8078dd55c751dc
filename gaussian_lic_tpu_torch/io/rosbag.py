"""Minimal pure-Python ROS1 bag (format 2.0) reader for the Gaussian-LIC input
topics — the ingest path a reference user already has data for (README.md:93-118
replays rosbags through Coco-LIC; mapping.cpp:211-213 subscribes the three
topics this module extracts):

  * points: sensor_msgs/PointCloud2 with PCL PointXYZRGB layout (gaussian.cpp:60-61)
  * pose:   geometry_msgs/PoseStamped (mapping.cpp:35)
  * image:  sensor_msgs/Image, bgr8/rgb8 (gaussian.cpp:45 converts to BGR8)

No ROS installation needed: records are parsed straight from the bag container
(op codes per the rosbag 2.0 spec), chunks may be uncompressed or bz2 (stdlib).
`RosbagStream` yields engine-ready FrameInput triplets through the same ±10 ms
StreamAligner the live pipeline uses. The counterpart of the JAX package's
`io/rosbag.py` (pure numpy there too), on this package's FrameInput and
StreamAligner.
"""

from __future__ import annotations

import bz2
import struct
from dataclasses import dataclass
from typing import Dict, Iterator, List, Tuple

import numpy as np

from gaussian_lic_tpu_torch.engine.dataset import FrameInput
from gaussian_lic_tpu_torch.engine.stream import StreamAligner

_OP_MSG = 0x02
_OP_BAGHDR = 0x03
_OP_INDEX = 0x04
_OP_CHUNK = 0x05
_OP_CHUNKINFO = 0x06
_OP_CONN = 0x07


def _parse_header(buf: bytes) -> Dict[str, bytes]:
    fields: Dict[str, bytes] = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        field = buf[off:off + flen]
        off += flen
        eq = field.index(b"=")
        fields[field[:eq].decode()] = field[eq + 1:]
    return fields


def _iter_records(data: bytes, off: int = 0) -> Iterator[Tuple[Dict[str, bytes], bytes]]:
    n = len(data)
    while off < n:
        (hlen,) = struct.unpack_from("<I", data, off)
        off += 4
        header = _parse_header(data[off:off + hlen])
        off += hlen
        (dlen,) = struct.unpack_from("<I", data, off)
        off += 4
        payload = data[off:off + dlen]
        off += dlen
        yield header, payload


# --------------------------------------------------------------------------
# message deserializers (ROS serialization: little-endian, packed)
# --------------------------------------------------------------------------

def _read_string(buf: bytes, off: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    return buf[off:off + n].decode(errors="replace"), off + n


def _read_header_stamp(buf: bytes, off: int) -> Tuple[float, int]:
    # std_msgs/Header: uint32 seq, time stamp (secs, nsecs), string frame_id
    _seq, secs, nsecs = struct.unpack_from("<III", buf, off)
    off += 12
    _frame, off = _read_string(buf, off)
    return secs + nsecs * 1e-9, off


def parse_pose_stamped(buf: bytes) -> Tuple[float, np.ndarray, np.ndarray]:
    """→ (stamp, R_wc (3,3), t_wc (3,)). Quaternion is xyzw (ROS convention);
    the reference reads it as world-from-camera (gaussian.cpp:52-57)."""
    stamp, off = _read_header_stamp(buf, 0)
    px, py, pz, qx, qy, qz, qw = struct.unpack_from("<7d", buf, off)
    t = np.array([px, py, pz], np.float32)
    x, y, z, w = qx, qy, qz, qw
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)
    return stamp, R, t


def parse_image(buf: bytes) -> Tuple[float, np.ndarray]:
    """→ (stamp, RGB uint8 (H,W,3)). Accepts bgr8 / rgb8 / mono8."""
    stamp, off = _read_header_stamp(buf, 0)
    h, w = struct.unpack_from("<II", buf, off)
    off += 8
    encoding, off = _read_string(buf, off)
    _bigendian = buf[off]
    off += 1
    (step,) = struct.unpack_from("<I", buf, off)
    off += 4
    (dlen,) = struct.unpack_from("<I", buf, off)
    off += 4
    raw = np.frombuffer(buf, np.uint8, count=dlen, offset=off)
    enc = encoding.lower()
    if enc in ("bgr8", "rgb8"):
        img = raw.reshape(h, step)[:, : w * 3].reshape(h, w, 3)
        if enc == "bgr8":
            img = img[:, :, ::-1]
    elif enc == "mono8":
        img = np.repeat(raw.reshape(h, step)[:, :w, None], 3, axis=2)
    else:
        raise ValueError(f"unsupported image encoding {encoding!r}")
    return stamp, np.ascontiguousarray(img)


_DATATYPE_NP = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
                5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64}


def parse_pointcloud2(buf: bytes) -> Tuple[float, np.ndarray, np.ndarray]:
    """→ (stamp, points (N,3) f32, colors (N,3) f32 in [0,1]).

    Understands the PCL PointXYZRGB wire layout the reference consumes
    (fromROSMsg, gaussian.cpp:60-61): float32 x/y/z + packed rgb (float32 or
    uint32 bit pattern 0x00RRGGBB). Missing rgb → mid-gray."""
    stamp, off = _read_header_stamp(buf, 0)
    h, w = struct.unpack_from("<II", buf, off)
    off += 8
    (nfields,) = struct.unpack_from("<I", buf, off)
    off += 4
    fields = []
    for _ in range(nfields):
        name, off = _read_string(buf, off)
        f_off, dtype, count = struct.unpack_from("<IBI", buf, off)
        off += 9
        fields.append((name, f_off, dtype, count))
    _bigendian = buf[off]
    off += 1
    point_step, _row_step = struct.unpack_from("<II", buf, off)
    off += 8
    (dlen,) = struct.unpack_from("<I", buf, off)
    off += 4
    raw = np.frombuffer(buf, np.uint8, count=dlen, offset=off)
    n = h * w
    if n == 0 or point_step == 0:
        return stamp, np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32)
    rec = raw[: n * point_step].reshape(n, point_step)

    def col(name):
        for fname, f_off, dtype, _count in fields:
            if fname == name:
                npdt = _DATATYPE_NP[dtype]
                width = np.dtype(npdt).itemsize
                return rec[:, f_off:f_off + width].copy().view(npdt).reshape(n)
        return None

    x, y, z = col("x"), col("y"), col("z")
    if x is None or y is None or z is None:
        raise ValueError("PointCloud2 lacks x/y/z fields")
    pts = np.stack([x, y, z], axis=1).astype(np.float32)
    rgbf = col("rgb")
    if rgbf is None:
        rgbf = col("rgba")
    if rgbf is None:
        cols_ = np.full((n, 3), 0.5, np.float32)
    else:
        bits = rgbf.view(np.uint32) if rgbf.dtype != np.uint32 else rgbf
        r = ((bits >> 16) & 0xFF).astype(np.float32) / 255.0
        g = ((bits >> 8) & 0xFF).astype(np.float32) / 255.0
        b = (bits & 0xFF).astype(np.float32) / 255.0
        cols_ = np.stack([r, g, b], axis=1)
    finite = np.isfinite(pts).all(axis=1)
    return stamp, pts[finite], cols_[finite]


# --------------------------------------------------------------------------
# bag container
# --------------------------------------------------------------------------

@dataclass
class _Conn:
    topic: str
    msg_type: str


def read_bag_messages(path: str) -> Iterator[Tuple[str, str, bytes]]:
    """Yield (topic, msg_type, serialized_bytes) for every message, in file
    order. Supports uncompressed and bz2 chunks, plus bare top-level records."""
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"#ROSBAG V2.0"):
            raise ValueError(f"not a ROS1 bag v2.0: {path} ({magic[:20]!r})")
        data = f.read()

    conns: Dict[int, _Conn] = {}

    def handle(header: Dict[str, bytes], payload: bytes):
        op = header["op"][0]
        if op == _OP_CONN:
            conn_id = struct.unpack("<I", header["conn"])[0]
            sub = _parse_header(payload)
            conns[conn_id] = _Conn(
                topic=header.get("topic", sub.get("topic", b"")).decode(),
                msg_type=sub.get("type", b"").decode(),
            )
        elif op == _OP_MSG:
            conn_id = struct.unpack("<I", header["conn"])[0]
            c = conns.get(conn_id)
            if c is not None:
                yield_list.append((c.topic, c.msg_type, payload))

    yield_list: List[Tuple[str, str, bytes]] = []
    for header, payload in _iter_records(data):
        op = header["op"][0]
        if op == _OP_CHUNK:
            comp = header.get("compression", b"none").decode()
            if comp == "none":
                chunk = payload
            elif comp == "bz2":
                chunk = bz2.decompress(payload)
            else:
                raise ValueError(f"unsupported chunk compression {comp!r} "
                                 "(only none/bz2 without external deps)")
            for h2, p2 in _iter_records(chunk):
                handle(h2, p2)
                while yield_list:
                    yield yield_list.pop(0)
        elif op in (_OP_BAGHDR, _OP_INDEX, _OP_CHUNKINFO):
            continue
        else:
            handle(header, payload)
            while yield_list:
                yield yield_list.pop(0)


class RosbagStream:
    """Replay the three Gaussian-LIC topics from a rosbag as aligned FrameInputs
    (the offline equivalent of the ROS node's subscriber trio + aligner)."""

    def __init__(
        self,
        path: str,
        points_topic: str = "/points_for_gs",
        pose_topic: str = "/pose_for_gs",
        image_topic: str = "/image_for_gs",
        tol: float = 0.01,
    ):
        self.path = path
        self.points_topic = points_topic
        self.pose_topic = pose_topic
        self.image_topic = image_topic
        self.tol = tol

    def __iter__(self) -> Iterator[FrameInput]:
        aligner = StreamAligner(self.tol)
        for topic, _msg_type, raw in read_bag_messages(self.path):
            if topic == self.points_topic:
                stamp, pts, cols = parse_pointcloud2(raw)
                aligner.push_points(stamp, (pts, cols))
            elif topic == self.pose_topic:
                stamp, R, t = parse_pose_stamped(raw)
                aligner.push_pose(stamp, (R, t))
            elif topic == self.image_topic:
                stamp, img = parse_image(raw)
                aligner.push_image(stamp, img)
            else:
                continue
            # drain: a drop may unblock the next triple within the same push
            # (batch replay has no later pushes to retry on, unlike live feeds)
            while True:
                got = aligner.pop_aligned()
                if got is None:
                    if not (aligner.points and aligner.poses and aligner.images):
                        break
                    continue  # something was dropped; retry
                stamp, (pts, cols), (R, t), img = got
                yield FrameInput(timestamp=stamp, R_wc=R, t_wc=t, image=img,
                                 points=pts, colors=cols)
