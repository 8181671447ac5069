"""Wavefront .obj loader producing triangle soups (NumPy).

Goes through the native parser (``native/raytpu_native.cpp``), the one the
JAX package uses by default: v / f records, every face form, negative
indices, fan triangulation of n-gons.
"""

from __future__ import annotations

import numpy as np

from raytracer_tpu_torch import knobs, native_bridge


def load_obj(path: str) -> np.ndarray:
    """Parse a .obj file -> f32[T, 3, 3] triangles (v0, v1, v2)."""
    knobs.fixed("RAYTPU_NATIVE")
    return native_bridge.load_obj(path)
