"""``terrain``: a height field of (n-1)^2 * 2 triangles over
[-extent, extent]^2, the sum of sin(fx x + px) sin(fz z + pz) waves with
(fx, fz, amp) from ``spec["waves"]``. The seed draws the waves' phases
and the order of their amplitudes; the grid, the extent and the set of
wave sizes stay, so every seed has the same triangle count."""

import numpy as np

from portbench.inputs import materials


def make(spec: dict, seed: int):
    rng = np.random.default_rng(seed)
    n, ext = int(spec["n"]), float(spec["extent"])
    waves = np.asarray(spec["waves"], np.float64)
    amps = waves[rng.permutation(len(waves)), 2]
    phases = rng.uniform(0.0, 2.0 * np.pi, (len(waves), 2))
    xs = np.linspace(-ext, ext, n, dtype=np.float32)
    x, z = np.meshgrid(xs, xs, indexing="ij")
    y = np.zeros_like(x)
    for (fx, fz, _), amp, (px, pz) in zip(waves, amps, phases):
        y += (amp * np.sin(fx * x + px) * np.sin(fz * z + pz)).astype(
            np.float32)
    grid = np.stack([x, y, z], axis=-1)
    a, b, c, d = grid[:-1, :-1], grid[1:, :-1], grid[1:, 1:], grid[:-1, 1:]
    t1 = np.stack([a, b, c], axis=2).reshape(-1, 3, 3)
    t2 = np.stack([a, c, d], axis=2).reshape(-1, 3, 3)
    verts = np.concatenate([t1, t2]).astype(np.float32)
    return verts, materials(len(verts), spec["albedo"], spec["material"])
