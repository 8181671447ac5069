"""Shared set-up of the benchmark's CPU tests: the repository root on the
import path, and the cells' overrides that shrink a run to a size a CPU
test holds (the same code paths, the program's plain versions)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {
    "flagship-720p.headless": {
        "config": {"render": {"width": 64, "height": 32, "max_bounces": 3,
                              "band_rays": 1024},
                   "scene": {"n": 14}},
        "traffic": {"check": {"paths": 2048, "pixels_min": 32,
                              "pixels_max": 128, "frame_pixels": 32}}},
    "c12-640x480.headless": {
        "config": {"render": {"width": 64, "height": 48}},
        "traffic": {"check": {"paths": 2048, "pixels_min": 32,
                              "pixels_max": 256, "frame_pixels": 32}}},
}
SECONDS = {"flagship-720p.headless": 1.0, "c12-640x480.headless": 0.5}
