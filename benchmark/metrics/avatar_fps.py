"""Frames completed in the window over the window's seconds, in the
avatar-only frames: capture_fps under a name of its own, whose bound
follows the avatar-only cell's spread and not the textured cell's."""

from benchmark.metrics.capture_fps import read  # noqa: F401
