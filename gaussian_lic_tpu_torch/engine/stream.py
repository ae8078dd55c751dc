"""Stream alignment and lifecycle (reference C1/C21, src/mapping.cpp).

The counterpart of the JAX package's `engine/stream.py`, with the same
policy and the same npz schema, so a stream directory written by either
package replays in the other.

The ROS subscriber trio + mutex queues (mapping.cpp:31-62) becomes a plain
`StreamAligner` with three timestamped queues and the same ±10 ms alignment policy
(getAlignedData, mapping.cpp:64-122): take the oldest point message, discard poses/
images more than 10 ms older, and drop the point message if the best candidate is
more than 10 ms newer. The watchdog (mapping.cpp:224-234) becomes `Watchdog`:
once the map is initialized, >1 s without a point message ends the run.

Data sources are pluggable: `RecordedStream` replays an npz-per-frame directory
(the test/offline stand-in for the Coco-LIC ROS feed, SURVEY.md §2 C1).
"""

from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Iterator, Optional, Tuple

import numpy as np

from gaussian_lic_tpu_torch.engine.dataset import FrameInput

ALIGN_TOL = 0.01      # seconds (mapping.cpp:75,85)
WATCHDOG_TIMEOUT = 1.0  # seconds (mapping.cpp:229)


@dataclass
class _Stamped:
    stamp: float
    payload: Any


class StreamAligner:
    """Three-queue timestamp aligner with the reference's drop policy."""

    def __init__(self, tol: float = ALIGN_TOL):
        self.tol = tol
        self.points: Deque[_Stamped] = deque()
        self.poses: Deque[_Stamped] = deque()
        self.images: Deque[_Stamped] = deque()
        self.last_point_time: float = 0.0

    def push_points(self, stamp: float, payload: Any, wall_time: Optional[float] = None):
        self.points.append(_Stamped(stamp, payload))
        self.last_point_time = time.monotonic() if wall_time is None else wall_time

    def push_pose(self, stamp: float, payload: Any):
        self.poses.append(_Stamped(stamp, payload))

    def push_image(self, stamp: float, payload: Any):
        self.images.append(_Stamped(stamp, payload))

    def pop_aligned(self) -> Optional[Tuple[float, Any, Any, Any]]:
        """Returns (stamp, points, pose, image) or None (mapping.cpp:64-122)."""
        if not self.points or not self.poses or not self.images:
            return None
        frame_time = self.points[0].stamp

        while self.poses and self.poses[0].stamp < frame_time - self.tol:
            self.poses.popleft()
        if not self.poses:
            return None
        if self.poses[0].stamp > frame_time + self.tol:
            self.points.popleft()  # unmatched point cloud: drop it
            return None

        while self.images and self.images[0].stamp < frame_time - self.tol:
            self.images.popleft()
        if not self.images:
            return None
        if self.images[0].stamp > frame_time + self.tol:
            self.points.popleft()
            return None

        pt = self.points.popleft()
        pose = self.poses.popleft()
        img = self.images.popleft()
        return frame_time, pt.payload, pose.payload, img.payload


class NativeStreamAligner:
    """StreamAligner backed by the C++ runtime (csrc/glic_runtime.cpp) — the
    native ingest path matching the reference's C++ subscriber queues
    (mapping.cpp:31-122). Payloads are kept in a Python handle table; the queue
    discipline, alignment, and drop policy run under the native mutex (usable
    from producer threads without holding the GIL for queue work)."""

    def __init__(self, tol: float = ALIGN_TOL):
        import ctypes

        from gaussian_lic_tpu_torch import native

        lib = native.get_lib()
        if lib is None:
            raise RuntimeError("native runtime unavailable (no g++ or build failed)")
        self._lib = lib
        self._ptr = lib.glic_aligner_new(float(tol))
        self._ct = ctypes
        self._payloads: dict = {}
        self._next = 1
        self.tol = tol

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None and getattr(self, "_ptr", None):
            lib.glic_aligner_free(self._ptr)
            self._ptr = None

    def _put(self, payload: Any) -> int:
        h = self._next
        self._next += 1
        self._payloads[h] = payload
        return h

    def push_points(self, stamp: float, payload: Any, wall_time: Optional[float] = None):
        wall = time.monotonic() if wall_time is None else wall_time
        self._lib.glic_aligner_push_points(self._ptr, stamp, self._put(payload), wall)

    def push_pose(self, stamp: float, payload: Any):
        self._lib.glic_aligner_push_pose(self._ptr, stamp, self._put(payload))

    def push_image(self, stamp: float, payload: Any):
        self._lib.glic_aligner_push_image(self._ptr, stamp, self._put(payload))

    @property
    def last_point_time(self) -> float:
        return self._lib.glic_aligner_last_point_walltime(self._ptr)

    @property
    def dropped(self) -> int:
        return int(self._lib.glic_aligner_dropped(self._ptr))

    def pop_aligned(self) -> Optional[Tuple[float, Any, Any, Any]]:
        ct = self._ct
        stamp = ct.c_double()
        pts = ct.c_uint64()
        pose = ct.c_uint64()
        img = ct.c_uint64()
        dropped = (ct.c_uint64 * 64)()
        n_dropped = ct.c_int()
        ok = self._lib.glic_aligner_pop(
            self._ptr, ct.byref(stamp), ct.byref(pts), ct.byref(pose),
            ct.byref(img), dropped, ct.byref(n_dropped),
        )
        for i in range(n_dropped.value):
            self._payloads.pop(dropped[i], None)
        if not ok:
            return None
        return (
            stamp.value,
            self._payloads.pop(pts.value),
            self._payloads.pop(pose.value),
            self._payloads.pop(img.value),
        )


def make_aligner(tol: float = ALIGN_TOL, prefer_native: bool = True):
    """The native aligner when the C++ runtime is buildable, else pure Python."""
    if prefer_native:
        try:
            return NativeStreamAligner(tol)
        except RuntimeError:
            pass
    return StreamAligner(tol)


class Watchdog:
    """End-of-stream detector (mapping.cpp:224-234): fires once the map is
    initialized and no point message has arrived for `timeout` seconds."""

    def __init__(self, timeout: float = WATCHDOG_TIMEOUT):
        self.timeout = timeout
        self.initialized = False

    def expired(self, aligner: StreamAligner, now: Optional[float] = None) -> bool:
        if not self.initialized or aligner.last_point_time == 0.0:
            return False
        now = time.monotonic() if now is None else now
        return (now - aligner.last_point_time) > self.timeout


class RecordedStream:
    """Replay a recorded sequence directory of per-frame npz files.

    Each `frame_XXXX.npz` holds: timestamp (), R_wc (3,3), t_wc (3,),
    image (H,W,3) uint8, points (N,3) f32, colors (N,3) f32 in [0,1].
    """

    def __init__(self, path: str):
        self.path = path
        self.files = sorted(
            f for f in os.listdir(path) if f.startswith("frame_") and f.endswith(".npz")
        )
        if not self.files:
            raise FileNotFoundError(f"no frame_*.npz under {path}")

    def __len__(self) -> int:
        return len(self.files)

    def __iter__(self) -> Iterator[FrameInput]:
        for f in self.files:
            z = np.load(os.path.join(self.path, f))
            yield FrameInput(
                timestamp=float(z["timestamp"]),
                R_wc=z["R_wc"],
                t_wc=z["t_wc"],
                image=z["image"],
                points=z["points"],
                colors=z["colors"],
            )

    @staticmethod
    def write_frame(path: str, idx: int, frame: FrameInput) -> None:
        np.savez_compressed(
            os.path.join(path, f"frame_{idx:05d}.npz"),
            timestamp=np.asarray(frame.timestamp),
            R_wc=np.asarray(frame.R_wc, np.float32),
            t_wc=np.asarray(frame.t_wc, np.float32),
            image=frame.image_u8(),
            points=np.asarray(frame.points, np.float32),
            colors=np.asarray(frame.colors, np.float32),
        )
