"""Pinhole camera: f64 host pose math emitted as f32 uniforms.

The same formulas as ``raytracer_tpu.core.camera`` (reference
``scene/Camera.java:44-68``); only ``uniforms`` differs, building torch
tensors on a given device.
"""

from __future__ import annotations

import math

import numpy as np

from raytracer_tpu_torch.core.types import CameraUniforms

# WASD/QE step vectors (reference VulkanApp.java:756-769).
KEY_STEPS = {
    "W": (0.0, 0.0, -6.5),
    "S": (0.0, 0.0, 15.0),
    "A": (-5.5, 0.0, 0.0),
    "D": (5.5, 0.0, 0.0),
    "Q": (0.0, 3.5, 0.0),
    "E": (0.0, -3.5, 0.0),
}


def _unit(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


class Camera:
    """Mutable host-side camera state."""

    def __init__(self, origin, look_at, v_up=(0.0, 1.0, 0.0),
                 vfov_deg: float = 20.0, aspect_ratio: float = 1280.0 / 720.0):
        self.origin = np.asarray(origin, np.float64)
        self.look_at = np.asarray(look_at, np.float64)
        self.v_up = np.asarray(v_up, np.float64)
        self.vfov_deg = float(vfov_deg)
        self.aspect_ratio = float(aspect_ratio)
        self.frame_count = 0
        self._recalculate_viewport()

    def _recalculate_viewport(self) -> None:
        theta = math.radians(self.vfov_deg)
        h = math.tan(theta / 2.0)
        viewport_height = 2.0 * h
        viewport_width = self.aspect_ratio * viewport_height

        w = _unit(self.origin - self.look_at)
        u = _unit(np.cross(self.v_up, w))
        v = np.cross(w, u)

        self.horizontal = u * viewport_width
        self.vertical = v * viewport_height
        self.lower_left_corner = (
            self.origin - self.horizontal / 2.0 - self.vertical / 2.0 - w)

    def set_origin(self, origin) -> None:
        self.origin = np.asarray(origin, np.float64)
        self._recalculate_viewport()

    def move(self, key: str) -> None:
        """One WASD/QE step; resets accumulation."""
        step = KEY_STEPS[key.upper()]
        self.set_origin(self.origin + np.asarray(step))
        self.reset_accumulation()

    def reset_accumulation(self) -> None:
        self.frame_count = 0

    def increment_frame_count(self) -> None:
        self.frame_count += 1

    def uniforms(self, sky_enabled: bool = True, exposure: float = 0.0,
                 device="cuda") -> CameraUniforms:
        """This frame's uniforms as f32/i32 tensors on ``device``."""
        return CameraUniforms.create(
            origin=self.origin, lower_left_corner=self.lower_left_corner,
            horizontal=self.horizontal, vertical=self.vertical,
            frame_count=self.frame_count, sky_enabled=sky_enabled,
            exposure=exposure, device=device)


def default_camera(width: int = 1280, height: int = 720) -> Camera:
    """The reference's startup pose (VulkanApp.java:132-138)."""
    return Camera(origin=(-25.0, 30.0, 140.0), look_at=(0.0, 0.0, 0.0),
                  v_up=(0.0, 1.0, 0.0), vfov_deg=20.0,
                  aspect_ratio=width / height)
