"""Utilities of the port (pose_tpu/utils): the profiler hooks."""
