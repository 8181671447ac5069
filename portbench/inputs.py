"""The benchmark's inputs, made from a configuration file and a seed.

Scenes are triangle soups (f32[T, 3, 3] vertices, f32[T, 4] rgb + type
materials) that both the measured program and the reference are handed.
The configuration's ``scene.kind`` names a generator file,
``portbench/scenes/<kind>.py`` (a ``make(spec, seed)``), the benchmark's
own copy, so a change to the program's asset code moves no yardstick and
a later scene is a new file. The seed changes where things are, never how
much there is. Cameras are the reference renderer's pinhole
(``scene/Camera.java``): pose math in float64, the uniforms rounded once
to float32.
"""

from __future__ import annotations

import math

import numpy as np

from portbench import byname


def materials(n: int, albedo, mtype: float) -> np.ndarray:
    """n rows of rgb ``albedo`` and material type ``mtype``."""
    m = np.zeros((n, 4), np.float32)
    m[:, 0:3] = albedo
    m[:, 3] = mtype
    return m


def scene(config: dict, seed: int):
    """(verts, mats) of the configuration's scene for ``seed``."""
    spec = config["scene"]
    return byname.load("scenes", spec["kind"]).make(spec, seed)


def _unit(v):
    return v / np.linalg.norm(v)


def uniforms(origin, look_at, v_up, vfov_deg: float, aspect: float):
    """Pinhole pose -> (origin, lower_left_corner, horizontal, vertical)
    as float32 tuples (float64 math, rounded once)."""
    origin = np.asarray(origin, np.float64)
    h = math.tan(math.radians(vfov_deg) / 2.0)
    vh = 2.0 * h
    vw = aspect * vh
    w = _unit(origin - np.asarray(look_at, np.float64))
    u = _unit(np.cross(np.asarray(v_up, np.float64), w))
    v = np.cross(w, u)
    hor, ver = u * vw, v * vh
    llc = origin - hor / 2.0 - ver / 2.0 - w
    return tuple(tuple(float(x) for x in np.asarray(a, np.float32))
                 for a in (origin, llc, hor, ver))


def camera(config: dict) -> tuple:
    """The configuration's camera as uniforms (pose 0 of a run)."""
    cam, r = config["camera"], config["render"]
    return uniforms(cam["origin"], cam["look_at"], cam["v_up"],
                    float(cam["vfov_deg"]),
                    float(r["width"]) / float(r["height"]))
