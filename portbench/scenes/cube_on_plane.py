"""``cube_on_plane``: the reference's cube.obj (12 triangles, half size
``cube_half``) over ground_plane.obj (2 triangles scaled by
``plane_scale``). The seed turns the cube about y (0 to 90 degrees) and
moves it on the plane by up to ``max_offset`` in x and z; its size and
the triangle count stay."""

import math

import numpy as np

from portbench.inputs import materials

_CORNERS = np.array([
    [-1, -1, 1], [1, -1, 1], [-1, 1, 1], [1, 1, 1],
    [-1, 1, -1], [1, 1, -1], [-1, -1, -1], [1, -1, -1]], np.float64)
_FACES = np.array([
    (0, 1, 3), (0, 3, 2), (2, 3, 5), (2, 5, 4), (4, 5, 7), (4, 7, 6),
    (6, 7, 1), (6, 1, 0), (1, 7, 5), (1, 5, 3), (6, 0, 2), (6, 2, 4)])
_PLANE = np.array([[-1, 0, 1], [1, 0, 1], [1, 0, -1], [-1, 0, -1]],
                  np.float64)[np.array([(0, 1, 2), (0, 2, 3)])]


def make(spec: dict, seed: int):
    rng = np.random.default_rng(seed)
    yaw = rng.uniform(0.0, 0.5 * np.pi)
    off = rng.uniform(-1.0, 1.0, 2) * float(spec["max_offset"])
    c, s = math.cos(yaw), math.sin(yaw)
    rot = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    cube = (_CORNERS * float(spec["cube_half"])) @ rot.T
    cube = cube + np.array([off[0], spec["cube_y"], off[1]])
    plane = _PLANE * np.array(spec["plane_scale"], np.float64) \
        + np.array([0.0, spec["plane_y"], 0.0])
    verts = np.concatenate([plane, cube[_FACES]]).astype(np.float32)
    return verts, materials(len(verts), spec["albedo"], spec["material"])
