"""Convert a Gaussian-LIC rosbag to a RecordedStream directory, with the
PyTorch port's reader and writer (no JAX).

Usage:
    python tools/bag_to_stream_torch.py input.bag out_dir/ \\
        [--points-topic /points_for_gs --pose-topic /pose_for_gs --image-topic /image_for_gs]

The counterpart of tools/bag_to_stream.py, with the same arguments and the
same npz-per-frame output (engine.stream.RecordedStream), which replays
faster than parsing the bag. Host-only I/O.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("bag")
    ap.add_argument("out_dir")
    ap.add_argument("--points-topic", default="/points_for_gs")
    ap.add_argument("--pose-topic", default="/pose_for_gs")
    ap.add_argument("--image-topic", default="/image_for_gs")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    from gaussian_lic_tpu_torch.engine.stream import RecordedStream
    from gaussian_lic_tpu_torch.io.rosbag import RosbagStream

    os.makedirs(args.out_dir, exist_ok=True)
    n = 0
    for frame in RosbagStream(args.bag, points_topic=args.points_topic,
                              pose_topic=args.pose_topic,
                              image_topic=args.image_topic):
        RecordedStream.write_frame(args.out_dir, n, frame)
        n += 1
    print(f"wrote {n} aligned frames to {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
