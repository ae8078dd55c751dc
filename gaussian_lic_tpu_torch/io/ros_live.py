"""Live ROS1 topic ingestion without a ROS installation.

The reference is a roscpp node subscribing to three topics from Coco-LIC
(`/points_for_gs`, `/pose_for_gs`, `/image_for_gs` — mapping.cpp:203-242).
This module speaks the two wire protocols a ROS1 subscriber needs — the
master/slave XML-RPC API and TCPROS — directly over the standard library, so
the mapping node can sit in a live ROS graph with zero ROS dependencies:

  * `registerSubscriber` against the master (`ROS_MASTER_URI`) announces the
    subscription and returns the current publisher URIs; a minimal slave
    XML-RPC server handles the master's `publisherUpdate` callbacks so
    publishers that appear later are picked up too.
  * Each publisher is asked `requestTopic(... [['TCPROS']])`; the returned
    (host, port) speaks TCPROS: one length-prefixed connection header
    exchange (callerid/topic/md5sum/type), then length-prefixed serialized
    messages — the same bytes `io.rosbag` already deserializes.

`RosLiveStream` multiplexes the three receiver threads through the ±10 ms
`StreamAligner` (the reference's getAlignedData policy, mapping.cpp:64-122)
and yields engine-ready `FrameInput`s; iteration ends when the stream goes
quiet for `idle_timeout` seconds after the first frame, mirroring the
reference watchdog (mapping.cpp:224-234). The counterpart of the JAX
package's `io/ros_live.py` (standard library and numpy there too), on this
package's FrameInput, StreamAligner and message parsers.
"""

from __future__ import annotations

import os
import queue
import socket
import struct
import threading
import xmlrpc.client
from typing import Dict, Iterator, List, Optional, Tuple
from xmlrpc.server import SimpleXMLRPCServer

from gaussian_lic_tpu_torch.engine.dataset import FrameInput
from gaussian_lic_tpu_torch.engine.stream import StreamAligner
from gaussian_lic_tpu_torch.io.rosbag import (
    parse_image,
    parse_pointcloud2,
    parse_pose_stamped,
)

# ROS1 message md5sums (from `rosmsg md5`, kinetic..noetic — these are stable
# across distros). Publishers also accept the '*' wildcard from subscribers;
# we send the real sums and fall back to '*' for unlisted types.
MSG_MD5 = {
    "sensor_msgs/PointCloud2": "1158d486dd51d683ce2f1be655c3c181",
    "geometry_msgs/PoseStamped": "d3812c3cbc69362b77dc0b19b345f8f5",
    "sensor_msgs/Image": "060021388200f6f0f447d0fcd9c64743",
}

_PARSERS = {
    "sensor_msgs/PointCloud2": parse_pointcloud2,
    "geometry_msgs/PoseStamped": parse_pose_stamped,
    "sensor_msgs/Image": parse_image,
}


def _encode_tcpros_header(fields: Dict[str, str]) -> bytes:
    body = b""
    for k, v in fields.items():
        item = k.encode() + b"=" + v.encode()
        body += struct.pack("<I", len(item)) + item
    return struct.pack("<I", len(body)) + body


def _decode_tcpros_header(buf: bytes) -> Dict[str, str]:
    fields: Dict[str, str] = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        item = buf[off:off + flen]
        off += flen
        eq = item.find(b"=")
        if eq >= 0:
            fields[item[:eq].decode()] = item[eq + 1:].decode(errors="replace")
    return fields


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n > 0:
        b = sock.recv(min(n, 1 << 20))
        if not b:
            raise ConnectionError("TCPROS peer closed")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


class _SlaveServer:
    """Minimal ROS slave XML-RPC endpoint: enough API surface for the master
    to deliver `publisherUpdate` callbacks (new/removed publishers)."""

    def __init__(self, on_publisher_update):
        self._srv = SimpleXMLRPCServer(
            ("127.0.0.1", 0), logRequests=False, allow_none=True
        )
        host, port = self._srv.server_address
        self.uri = f"http://{host}:{port}/"
        self._on_update = on_publisher_update

        def publisherUpdate(caller_id, topic, publishers):
            self._on_update(topic, list(publishers))
            return (1, "", 0)

        self._srv.register_function(publisherUpdate, "publisherUpdate")
        self._srv.register_function(lambda cid: (1, "", os.getpid()), "getPid")
        self._srv.register_function(lambda cid: (1, "", []), "getBusInfo")
        self._srv.register_function(lambda cid: (1, "", []), "getBusStats")
        self._srv.register_function(
            lambda cid, msg="": (1, "", 0), "shutdown"
        )
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True, name="glic-ros-slave"
        )
        self._thread.start()

    def close(self):
        self._srv.shutdown()
        self._srv.server_close()


class _TopicSubscription:
    """One topic: tracks publisher URIs, runs a TCPROS receiver thread per
    publisher, posts (topic, raw_message) into the shared queue."""

    def __init__(self, topic: str, msg_type: str, caller_id: str,
                 out: "queue.Queue[Tuple[str, bytes]]"):
        self.topic = topic
        self.msg_type = msg_type
        self.caller_id = caller_id
        self.out = out
        self._threads: Dict[str, threading.Thread] = {}
        self._stop = threading.Event()
        self._lock = threading.Lock()

    def update_publishers(self, uris: List[str]):
        with self._lock:
            for uri in uris:
                t = self._threads.get(uri)
                if t is None or not t.is_alive():
                    th = threading.Thread(
                        target=self._run_publisher, args=(uri,), daemon=True,
                        name=f"glic-tcpros{self.topic}",
                    )
                    self._threads[uri] = th
                    th.start()

    def stop(self):
        self._stop.set()

    # -- TCPROS client ------------------------------------------------------
    def _run_publisher(self, pub_uri: str):
        try:
            proxy = xmlrpc.client.ServerProxy(pub_uri)
            code, _msg, proto = proxy.requestTopic(
                self.caller_id, self.topic, [["TCPROS"]]
            )
            if code != 1 or not proto or proto[0] != "TCPROS":
                return
            _, host, port = proto[0], proto[1], proto[2]
            with socket.create_connection((host, int(port)), timeout=10) as sock:
                sock.settimeout(None)
                sock.sendall(_encode_tcpros_header({
                    "callerid": self.caller_id,
                    "topic": self.topic,
                    "md5sum": MSG_MD5.get(self.msg_type, "*"),
                    "type": self.msg_type,
                    "tcp_nodelay": "1",
                }))
                (hlen,) = struct.unpack("<I", _recv_exact(sock, 4))
                reply = _decode_tcpros_header(_recv_exact(sock, hlen))
                if "error" in reply:
                    raise ConnectionError(
                        f"publisher rejected {self.topic}: {reply['error']}"
                    )
                while not self._stop.is_set():
                    (mlen,) = struct.unpack("<I", _recv_exact(sock, 4))
                    raw = _recv_exact(sock, mlen)
                    self.out.put((self.topic, raw))
        except (OSError, ConnectionError, xmlrpc.client.Error):
            return  # publisher went away; publisherUpdate restarts us


class RosLiveStream:
    """Iterator of aligned FrameInputs from a live ROS1 graph.

    Parameters mirror `io.rosbag.RosbagStream`; `master_uri` defaults to
    `$ROS_MASTER_URI` (http://localhost:11311). `idle_timeout` ends iteration
    once messages stop arriving (reference watchdog, mapping.cpp:224-234);
    pass None to iterate until `.stop()`.
    """

    def __init__(
        self,
        master_uri: Optional[str] = None,
        points_topic: str = "/points_for_gs",
        pose_topic: str = "/pose_for_gs",
        image_topic: str = "/image_for_gs",
        tol: float = 0.01,
        caller_id: str = "/gaussian_lic_tpu_torch",
        idle_timeout: Optional[float] = 2.0,
    ):
        self.master_uri = master_uri or os.environ.get(
            "ROS_MASTER_URI", "http://localhost:11311"
        )
        self.caller_id = caller_id
        self.tol = tol
        self.idle_timeout = idle_timeout
        self._topics = {
            points_topic: "sensor_msgs/PointCloud2",
            pose_topic: "geometry_msgs/PoseStamped",
            image_topic: "sensor_msgs/Image",
        }
        self.points_topic = points_topic
        self.pose_topic = pose_topic
        self.image_topic = image_topic
        self._queue: "queue.Queue[Tuple[str, bytes]]" = queue.Queue()
        self._subs: Dict[str, _TopicSubscription] = {}
        self._slave: Optional[_SlaveServer] = None
        self._started = False
        self._stopped = threading.Event()

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        if self._started:
            return
        self._slave = _SlaveServer(self._publisher_update)
        master = xmlrpc.client.ServerProxy(self.master_uri)
        for topic, msg_type in self._topics.items():
            sub = _TopicSubscription(topic, msg_type, self.caller_id, self._queue)
            self._subs[topic] = sub
            code, _msg, pubs = master.registerSubscriber(
                self.caller_id, topic, msg_type, self._slave.uri
            )
            if code == 1:
                sub.update_publishers(pubs)
        self._started = True

    def stop(self):
        self._stopped.set()
        for sub in self._subs.values():
            sub.stop()
        if self._started:
            try:
                master = xmlrpc.client.ServerProxy(self.master_uri)
                for topic in self._topics:
                    master.unregisterSubscriber(
                        self.caller_id, topic, self._slave.uri
                    )
            except (OSError, xmlrpc.client.Error):
                pass
        if self._slave is not None:
            self._slave.close()
            self._slave = None
        self._started = False

    def _publisher_update(self, topic: str, uris: List[str]):
        sub = self._subs.get(topic)
        if sub is not None:
            sub.update_publishers(uris)

    # -- iteration ----------------------------------------------------------
    def __iter__(self) -> Iterator[FrameInput]:
        self.start()
        aligner = StreamAligner(self.tol)
        try:
            while not self._stopped.is_set():
                try:
                    topic, raw = self._queue.get(timeout=self.idle_timeout)
                except queue.Empty:
                    break  # watchdog: stream went quiet
                try:
                    if topic == self.points_topic:
                        stamp, pts, cols = parse_pointcloud2(raw)
                        aligner.push_points(stamp, (pts, cols))
                    elif topic == self.pose_topic:
                        stamp, R, t = parse_pose_stamped(raw)
                        aligner.push_pose(stamp, (R, t))
                    elif topic == self.image_topic:
                        stamp, img = parse_image(raw)
                        aligner.push_image(stamp, img)
                except (ValueError, struct.error) as e:
                    # malformed message: drop it, keep the stream alive
                    print(f"[ros_live] bad message on {topic}: {e}")
                    continue
                while True:
                    got = aligner.pop_aligned()
                    if got is None:
                        if not (aligner.points and aligner.poses
                                and aligner.images):
                            break
                        continue  # a drop may unblock the next triple
                    stamp, (pts, cols), (R, t), img = got
                    yield FrameInput(timestamp=stamp, R_wc=R, t_wc=t,
                                     image=img, points=pts, colors=cols)
        finally:
            self.stop()
