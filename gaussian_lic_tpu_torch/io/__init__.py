"""I/O: PLY map export/import, checkpoints, rosbag and live-ROS ingest."""
