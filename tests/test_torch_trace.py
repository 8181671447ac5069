"""Kernel A's plain version against the JAX Pallas kernel (interpret mode).

``pallas_traverse(..., interpret=True)`` walks one stack per 1024-ray tile
and orders pushes by the tile's mean direction; the port walks each ray by
itself. The closest t is the same either way (strict ``t < closest``), so
``t`` must be bit-equal on every lane; normal, albedo and type may differ
only on lanes whose closest hit is an equal-t tie between triangles, and
those must stay under 1% of lanes.
"""

import numpy as np
import pytest
import torch

from torch_jax_refs import run_job, tie_lanes

from raytracer_tpu_torch.core.camera import Camera
from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.kernels import launches
from raytracer_tpu_torch.kernels.packet import _tile_major_pixels
from raytracer_tpu_torch.kernels.trace import trace4, trace4_plain
from raytracer_tpu_torch.kernels.tracer import (initial_seed,
                                                make_primary_rays)
from raytracer_tpu_torch.scene.builder import build_fast_scene_from_arrays
from raytracer_tpu_torch.utils import assets

torch.set_num_threads(2)

P = 1024


def _scene_arrays():
    terrain = assets.make_terrain(n=32, extent=30.0)
    cube = assets.make_cube() * 8.0 + np.array([5.0, 8.0, -3.0], np.float32)
    verts = np.concatenate([terrain, cube]).astype(np.float32)
    mats = np.zeros((verts.shape[0], 4), np.float32)
    r = np.random.default_rng(3)
    mats[:, 0:3] = r.uniform(0.2, 0.9, (verts.shape[0], 3))
    mats[:, 3] = r.integers(0, 4, verts.shape[0])
    return verts, mats


def _random_rays(scene):
    """Random rays, some axis-parallel, some starting exactly on a node's
    slab plane with that direction component 0 (NaN slab terms)."""
    r = np.random.default_rng(99)
    n4 = scene.nodes4.numpy()[:scene.num_nodes4].reshape(-1, 8, 16)
    lo, hi = n4[0, :, 0:3].min(0) - 5, n4[0, :, 3:6].max(0) + 5
    o = r.uniform(lo, hi, (P, 3)).astype(np.float32)
    d = r.standard_normal((P, 3)).astype(np.float32)
    d[: P // 6, r.integers(0, 3)] = 0.0          # one zero component
    d[P // 6: P // 4, 0] = 0.0                   # two zero components
    d[P // 6: P // 4, 2] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # Rays 0..63: origin on a real child box's min or max plane.
    kids = n4[:, :, 0:6].reshape(-1, 6)[n4[:, :, 6].reshape(-1) != 0]
    for i in range(64):
        ax = i % 3
        box = kids[r.integers(0, len(kids))]
        o[i, ax] = box[ax + 3 * (i // 3 % 2)]
        d[i] = r.standard_normal(3)
        d[i, ax] = 0.0
        d[i] /= np.linalg.norm(d[i])
    active = r.random(P) > 0.1
    return np.concatenate([o.T, d.T]).astype(np.float32), active


def _primary_rays():
    cfg = RenderConfig(width=32, height=32)
    cam = Camera(origin=(-30.0, 25.0, 60.0), look_at=(0.0, 2.0, 0.0),
                 vfov_deg=35.0, aspect_ratio=1.0).uniforms(device="cpu")
    xx, yy, alive = _tile_major_pixels(32, 32, P, "cpu")
    seed = initial_seed(cam, cfg, yy * 32 + xx, 0)
    _, o, d = make_primary_rays(cam, cfg, seed, xx, yy, 32)
    return torch.stack([*o, *d]).numpy(), alive.numpy()


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    verts, mats = _scene_arrays()
    scene = build_fast_scene_from_arrays(verts, mats, device="cpu")
    rand_rays, rand_active = _random_rays(scene)
    prim_rays, prim_active = _primary_rays()
    inp = dict(verts=verts, mats=mats, rand_rays=rand_rays,
               rand_active=rand_active, prim_rays=prim_rays,
               prim_active=prim_active)
    return scene, inp, run_job("trace", inp, tmp_path_factory.mktemp("tr"))


@pytest.mark.parametrize("name", ["rand", "prim"])
def test_kernel_a_plain_matches_pallas(case, name):
    scene, inp, ref = case
    cfg = RenderConfig()
    rays = torch.from_numpy(inp[f"{name}_rays"]).contiguous()
    active = torch.from_numpy(inp[f"{name}_active"])
    got = trace4_plain(scene, rays, active, cfg).numpy()
    want = ref[f"{name}_out"]
    assert got[0].tobytes() == want[0].tobytes(), "t must be bit-equal"
    differ = torch.from_numpy((got != want).any(0))
    ties = tie_lanes(scene, rays[0:3], rays[3:6], active, cfg)
    assert not (differ & ~ties).any(), "difference on a non-tie lane"
    assert int(differ.sum()) < 0.01 * P
    hits = (got[0] < cfg.t_max).mean()
    assert 0.2 < hits < 0.95, hits


def test_random_rays_cover_nan_slabs(case):
    """The random set really has rays whose slab term is 0 * inf."""
    scene, inp, _ = case
    rays = inp["rand_rays"]
    n4 = scene.nodes4.numpy().reshape(-1, 8, 16)
    planes = set(np.concatenate([n4[..., 0:6].reshape(-1)]).tolist())
    on_plane = [i for i in range(P) for ax in range(3)
                if rays[3 + ax, i] == 0.0 and float(rays[ax, i]) in planes]
    assert len(on_plane) >= 32


def test_trace4_routes_cpu_tensors_to_plain(case):
    scene, inp, _ = case
    rays = torch.from_numpy(inp["prim_rays"]).contiguous()
    active = torch.from_numpy(inp["prim_active"])
    launches.reset()
    out = trace4(scene, rays, active, RenderConfig())
    assert launches.plain["trace4"] == 1 and not launches.kernel
    assert out.shape == (8, P) and out.dtype == torch.float32
    with pytest.raises(ValueError):
        trace4(scene, rays.double(), active, RenderConfig())
