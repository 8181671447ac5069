"""Kernel 5's plain version (binary skip-link walk) against the JAX Pallas
kernel ``_trace_kernel`` in interpret mode.

``pallas_traverse(..., interpret=True)`` under ``RAYTPU_TRAVERSE=binary``
walks one node pointer per 1024-ray tile; ``trace2_plain`` walks each ray
by itself. A child box lies inside its parent's, so both test the same
leaves of a ray in the same pre-order: all 8 outputs must be bit-equal on
every lane, equal-t ties included, with the normal flip on (path shading)
and off (fixed light). The rays are random, a quarter of them parallel to
one or two axes and some starting on a node's slab plane (NaN slab terms),
on a scene of about 800 triangles.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_jax_refs import run_job

from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.kernels import launches
from raytracer_tpu_torch.kernels.trace import trace2, trace2_plain, traverse
from raytracer_tpu_torch.scene.builder import build_fast_scene_from_arrays
from raytracer_tpu_torch.utils import assets

torch.set_num_threads(2)

P = 2048


def scene_arrays():
    """About 800 triangles: a terrain and a cube, random materials."""
    terrain = assets.make_terrain(n=20, extent=30.0)
    cube = assets.make_cube() * 8.0 + np.array([5.0, 8.0, -3.0], np.float32)
    verts = np.concatenate([terrain, cube]).astype(np.float32)
    r = np.random.default_rng(3)
    mats = np.zeros((verts.shape[0], 4), np.float32)
    mats[:, 0:3] = r.uniform(0.2, 0.9, (verts.shape[0], 3))
    mats[:, 3] = r.integers(0, 4, verts.shape[0])
    return verts, mats


def random_rays(scene, n=P, seed=17):
    """f32[6, n] rays (a quarter axis-parallel, 64 starting on a binary
    node's slab plane) and bool[n] active."""
    r = np.random.default_rng(seed)
    n8 = scene.nodes8.numpy()[:scene.num_nodes]
    lo, hi = n8[0, 0:3] - 5, n8[0, 3:6] + 5
    o = r.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = r.standard_normal((n, 3)).astype(np.float32)
    d[: n // 8, r.integers(0, 3)] = 0.0
    d[n // 8: n // 4, 0] = 0.0
    d[n // 8: n // 4, 2] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    for i in range(64):
        ax = i % 3
        box = n8[r.integers(0, len(n8))]
        o[i, ax] = box[ax + 3 * (i // 3 % 2)]
        d[i] = r.standard_normal(3)
        d[i, ax] = 0.0
        d[i] /= np.linalg.norm(d[i])
    active = r.random(n) > 0.1
    return np.concatenate([o.T, d.T]).astype(np.float32), active


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    verts, mats = scene_arrays()
    scene = build_fast_scene_from_arrays(verts, mats, device="cpu")
    rays, active = random_rays(scene)
    inp = dict(verts=verts, mats=mats, rays=rays, active=active,
               shadings=np.array(["path", "fixed_light"]))
    ref = run_job("trace_shadings", inp, tmp_path_factory.mktemp("tr2"),
                  env={"RAYTPU_TRAVERSE": "binary"})
    return scene, inp, ref


@pytest.mark.parametrize("shading", ["path", "fixed_light"])
def test_trace2_plain_matches_pallas_bit_for_bit(case, shading):
    scene, inp, ref = case
    cfg = RenderConfig(shading=shading)
    rays = torch.from_numpy(inp["rays"]).contiguous()
    got = trace2_plain(scene, rays, torch.from_numpy(inp["active"]),
                       cfg).numpy()
    want = ref[f"{shading}_out"]
    assert got.tobytes() == want.tobytes(), np.argwhere(got != want)[:10]
    hits = (got[0] < cfg.t_max).mean()
    assert 0.2 < hits < 0.95, hits
    if shading == "path":
        # Flipped normals face the ray; raw ones need not.
        dot = (rays[3:6].numpy() * got[1:4]).sum(0)
        assert (dot <= 0).all()


def test_random_rays_cover_nan_slabs(case):
    """The set really has rays whose slab term is 0 * inf."""
    scene, inp, _ = case
    rays = inp["rays"]
    planes = set(scene.nodes8.numpy()[:scene.num_nodes, 0:6]
                 .reshape(-1).tolist())
    on_plane = [i for i in range(P) for ax in range(3)
                if rays[3 + ax, i] == 0.0 and float(rays[ax, i]) in planes]
    assert len(on_plane) >= 32


@pytest.mark.parametrize("knob", [("RAYTPU_TRAVERSE", "binary"),
                                  ("RAYTPU_NODE_SRC", "extract"),
                                  ("RAYTPU_TRAVERSE", "bvh4")])
def test_traverse_picks_the_walk_by_knob(case, monkeypatch, knob):
    scene, inp, ref = case
    monkeypatch.setenv(*knob)
    rays = torch.from_numpy(inp["rays"])
    launches.reset()
    res = traverse(scene, rays[0:3], rays[3:6],
                   torch.from_numpy(inp["active"]), RenderConfig())
    if knob[1] == "bvh4":
        assert dict(launches.plain) == {"trace4": 1}
    else:
        assert dict(launches.plain) == {"trace2": 1}
        np.testing.assert_array_equal(res.closest_t.numpy(),
                                      ref["path_out"][0])


def test_trace2_routes_cpu_tensors_and_checks_inputs(case):
    scene, inp, _ = case
    rays = torch.from_numpy(inp["rays"]).contiguous()
    active = torch.from_numpy(inp["active"])
    launches.reset()
    out = trace2(scene, rays, active, RenderConfig())
    assert launches.plain["trace2"] == 1 and not launches.kernel
    assert out.shape == (8, P) and launches.work["visits2"] > P
    with pytest.raises(ValueError):
        trace2(scene, rays[:5].contiguous(), active, RenderConfig())
    with pytest.raises(ValueError):
        trace2(dataclasses.replace(scene, num_nodes=0), rays, active,
               RenderConfig())


def test_empty_scene_misses_everywhere(case):
    _, inp, _ = case
    empty = build_fast_scene_from_arrays(np.zeros((0, 3, 3), np.float32),
                                         np.zeros((0, 4), np.float32),
                                         device="cpu")
    assert empty.num_nodes == 1
    cfg = RenderConfig()
    out = trace2_plain(empty, torch.from_numpy(inp["rays"]).contiguous(),
                       torch.from_numpy(inp["active"]), cfg)
    assert (out[0] == cfg.t_max).all() and (out[1:] == 0).all()
