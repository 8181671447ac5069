"""The table layouts ``RAYTPU_CLUSTER=2|4`` and ``RAYTPU_WIDE=16`` against
the JAX package.

The JAX package reads both knobs at import, so each layout's references
come from JAX children with the knob set for the whole child
(``torch_jax_refs.run_children``, the children at once, while the port
renders its frames): ``CLUSTER=2``, ``CLUSTER=4`` and ``WIDE=16`` in
full (``WIDE=16`` in two children: the interpret lowering of its kernel
A and of its kernel B take ~50 s each), the combined layouts 2/16 and
4/16 for their tables and a frame. The port reads the knobs when it
builds a table, and its scene keeps the layout.

Under each layout, on a terrain of 734 triangles:

* the host tables (``build_fast_scene_from_arrays``), the instanced TLAS
  (three BLASes combined, one instance mirrored), the refit tables
  (``CLUSTER`` only: the JAX capture asserts width 8, and the port's
  refuses width 16) and the LBVH tables (no wide table at width 16) are
  byte-equal to the JAX package's, the unit normals within 2 ulp;
* the plain kernel A (``trace4_plain``) against ``pallas_traverse`` in
  interpret mode, on 2048 random rays and 2048 primaries; the plain
  kernel B (``bounce12_plain``, ``cid``) against ``bounce_megakernel12``
  on two 2048-ray states (uniform budget, budgets 0-2); the plain binary
  walk (``trace2_plain``) against ``_trace_call`` (``CLUSTER`` only: the
  binary table has no width): t bit-equal, the rest equal except on
  equal-t tie lanes, state floats within 2e-5;
* a 64x32 two-band frame of the XLA render path (``RAYTPU_B0=mega``,
  ``RAYTPU_BOUNCE=mega``: the JAX package's own CPU path, no Pallas)
  against the JAX ``Renderer``, accumulator within 2e-5, u8 image equal
  except on bounce-0 tie pixels, ``rays_traced`` equal.
"""

import threading

import numpy as np
import pytest
import torch

from test_torch_bounce import _port_state
from test_torch_renderer import _bounce0_tie_pixels, _sub
from torch_jax_refs import assert_scene_tables, run_children, tie_lanes

from raytracer_tpu_torch.bvh.lbvh import (build_fast_scene_device,
                                          pad_to_cluster_multiple)
from raytracer_tpu_torch.core.camera import Camera
from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.engine.renderer import Renderer
from raytracer_tpu_torch.kernels import cuda_build, launches
from raytracer_tpu_torch.kernels.bounce import (ROW_ALIVE, ROW_BUDGET,
                                                ROW_SEED, bounce12_plain)
from raytracer_tpu_torch.kernels.packet import _tile_major_pixels
from raytracer_tpu_torch.kernels.trace import trace2_plain, trace4_plain
from raytracer_tpu_torch.kernels.tracer import (initial_seed,
                                                make_primary_rays)
from raytracer_tpu_torch.scene import instanced, refit
from raytracer_tpu_torch.scene.builder import build_fast_scene_from_arrays
from raytracer_tpu_torch.utils import assets

torch.set_num_threads(2)

P = 2048
# Layout -> (its knobs, (cluster size, wide width)).
LAYOUTS = {"c2": ({"RAYTPU_CLUSTER": "2"}, (2, 8)),
           "c4": ({"RAYTPU_CLUSTER": "4"}, (4, 8)),
           "w16": ({"RAYTPU_WIDE": "16"}, (8, 16)),
           "c2w16": ({"RAYTPU_CLUSTER": "2", "RAYTPU_WIDE": "16"}, (2, 16)),
           "c4w16": ({"RAYTPU_CLUSTER": "4", "RAYTPU_WIDE": "16"}, (4, 16))}
FULL = ("c2", "c4", "w16")          # every check
CLUSTER = ("c2", "c4")              # the binary walk and the refit
FRAME = dict(width=64, height=32, max_bounces=4, band_rays=1024)
MEGA = {"RAYTPU_B0": "mega", "RAYTPU_BOUNCE": "mega"}
CAM = dict(cam_origin=np.array([-30.0, 25.0, 60.0]),
           cam_look=np.array([0.0, 2.0, 0.0]), cam_vfov=35.0)
INSTANCE_KS = np.array([0, 1, 2, 1])
REFIT_PARAMS = np.array([[1, 1, 1, 0, 0, 0, 0.7, 0.6, 0.5, 0],
                         [2, -1.5, 1, 5, 1, -3, 0.5, 0.6, 0.7, 1]],
                        np.float32)


def _arrays():
    terrain = assets.make_terrain(n=20, extent=30.0)
    cube = assets.make_cube() * 8.0 + np.array([5.0, 8.0, -3.0], np.float32)
    verts = np.concatenate([terrain, cube]).astype(np.float32)
    mats = np.zeros((verts.shape[0], 4), np.float32)
    r = np.random.default_rng(3)
    mats[:, 0:3] = r.uniform(0.2, 0.9, (verts.shape[0], 3))
    mats[:, 3] = r.integers(0, 4, verts.shape[0])
    return verts, mats


def _meshes():
    return [assets.make_cube(), assets.make_icosphere(2, 3.0),
            assets.make_terrain(n=12)]


def _instance_params():
    r = np.random.default_rng(8)
    p = np.zeros((len(INSTANCE_KS), 10), np.float32)
    p[:, 0:3] = r.uniform(0.5, 3.0, (len(p), 3))
    p[0, 0] = -p[0, 0]                      # a mirrored instance
    p[:, 3:6] = r.uniform(-20, 20, (len(p), 3))
    p[:, 6:9] = r.uniform(0.1, 1.0, (len(p), 3))
    p[:, 9] = np.arange(len(p)) % 4
    return p


def _random_rays(bounds):
    """Random rays in and around the root box, some axis-parallel."""
    r = np.random.default_rng(99)
    lo, hi = bounds[0:3] - 5, bounds[3:6] + 5
    o = r.uniform(lo, hi, (P, 3)).astype(np.float32)
    d = r.standard_normal((P, 3)).astype(np.float32)
    d[: P // 6, 1] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.concatenate([o.T, d.T]).astype(np.float32), r.random(P) > 0.1


def _primary_rays():
    cfg = RenderConfig(width=64, height=32)
    cam = Camera(origin=CAM["cam_origin"], look_at=CAM["cam_look"],
                 vfov_deg=CAM["cam_vfov"], aspect_ratio=2.0).uniforms(
        device="cpu")
    xx, yy, alive = _tile_major_pixels(32, 64, P, "cpu")
    seed = initial_seed(cam, cfg, yy * 64 + xx, 0)
    _, o, d = make_primary_rays(cam, cfg, seed, xx, yy, 32)
    return torch.stack([*o, *d]).numpy(), alive.numpy()


def _state(r, bounds, budget):
    """A 2048-ray bounce state (f32 o3 d3 a3 alive, i32 seed budget)."""
    o = r.uniform(bounds[0:3], bounds[3:6], (P, 3)).astype(np.float32)
    d = r.standard_normal((P, 3)).astype(np.float32)
    d[:P // 8, 1] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    a = r.uniform(0.0, 1.0, (P, 3)).astype(np.float32)
    act = (r.random(P) < 0.8).astype(np.float32)
    seed = r.integers(0, 2 ** 32, P, dtype=np.uint64).astype(np.uint32)
    f = np.concatenate([o.T, d.T, a.T, act[None]]).astype(np.float32)
    return f, np.stack([seed.view(np.int32), budget.astype(np.int32)])


def _inputs():
    """Every child's job inputs, made from numpy seeds."""
    verts, mats = _arrays()
    lo, hi = verts.reshape(-1, 3).min(0), verts.reshape(-1, 3).max(0)
    bounds = np.concatenate([lo, hi]).astype(np.float32)
    rand_rays, rand_active = _random_rays(bounds)
    prim_rays, prim_active = _primary_rays()
    r = np.random.default_rng(2024)
    uf, ui = _state(r, bounds, np.full(P, 1 << 30))
    bf, bi = _state(r, bounds, r.integers(0, 3, P))
    meshes = _meshes()
    lv, lm = pad_to_cluster_multiple(verts, mats)
    base = dict(verts=verts, mats=mats, sky=1)
    return dict(
        trace=dict(base, rand_rays=rand_rays, rand_active=rand_active,
                   prim_rays=prim_rays, prim_active=prim_active),
        bounce=dict(base, bcap=1, uniform_f=uf, uniform_i=ui, budget_f=bf,
                    budget_i=bi, key_o=uf[0:3], key_d=uf[3:6],
                    key_alive=uf[9] > 0.5),
        binary=dict(base, rays=rand_rays, active=rand_active,
                    shadings=np.array(["path"])),
        instanced=dict(n_meshes=len(meshes), ks=np.array([len(INSTANCE_KS)]),
                       **{f"mesh_{i}": m for i, m in enumerate(meshes)},
                       **{f"k_{len(INSTANCE_KS)}": INSTANCE_KS,
                          f"params_{len(INSTANCE_KS)}": _instance_params()}),
        refit=dict(n_meshes=2, methods=np.array(["sah"]),
                   params=REFIT_PARAMS, moved=REFIT_PARAMS,
                   mesh_0=meshes[2], mesh_1=meshes[1]),
        lbvh_scene=dict(verts=lv, mats=lm),
        frames=dict(base, frames=1, **CAM,
                    **{f"cfg_{k}": v for k, v in FRAME.items()}))


def _children(inp):
    """(layout, its jobs) a JAX child."""
    tables = [("lbvh_scene", inp["lbvh_scene"], None),
              ("frames", inp["frames"], MEGA)]
    full = tables + [("trace", inp["trace"], None),
                     ("bounce", inp["bounce"], None),
                     ("instanced", inp["instanced"], None)]
    binary = [("trace_shadings", inp["binary"],
               {"RAYTPU_TRAVERSE": "binary"}), ("refit", inp["refit"], None)]
    return [("c2", full + binary), ("c4", full + binary),
            ("w16", full[:3]), ("w16", full[3:]),
            ("c2w16", tables), ("c4w16", tables)]


def _port_frame(name):
    """The port's XLA-path frame of a layout's scene -> (scene, accum,
    image, rays traced, the plain versions it booked)."""
    scene = _host_scene(name)
    cfg = RenderConfig(**FRAME)
    uni = Camera(origin=CAM["cam_origin"], look_at=CAM["cam_look"],
                 vfov_deg=CAM["cam_vfov"], aspect_ratio=2.0).uniforms(
        device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        for k, v in MEGA.items():
            mp.setenv(k, v)
        launches.reset()
        accum, image, stats = Renderer(cfg).render(scene, uni)
    return (scene, cfg, uni, accum.numpy(), image.numpy(),
            int(stats["rays_traced"]), set(launches.plain))


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """Each layout's JAX results, the children at once, and the port's
    frames, rendered meanwhile -> (inputs, layout -> job -> results,
    layout -> port frame)."""
    inp = _inputs()
    children = _children(inp)
    box = {}

    def run():
        # Both knobs for every child: the port frames below set them in
        # this process's environment meanwhile, which a child inherits.
        envs = {name: {"RAYTPU_CLUSTER": str(cs), "RAYTPU_WIDE": str(w)}
                for name, (_, (cs, w)) in LAYOUTS.items()}
        try:
            box["out"] = run_children(
                [(jobs, envs[name]) for name, jobs in children],
                tmp_path_factory.mktemp("layouts"))
        except Exception as e:  # re-raised below, in the test's thread
            box["error"] = e

    th = threading.Thread(target=run)
    th.start()
    try:
        frames = {name: _port_frame(name) for name in LAYOUTS}
    finally:
        th.join()
    if "error" in box:
        raise box["error"]
    ref = {name: {} for name in LAYOUTS}
    for (name, jobs), results in zip(children, box["out"]):
        ref[name].update({job: res for (job, _, _), res in
                          zip(jobs, results)})
    return inp, ref, frames


@pytest.fixture
def layout_env(monkeypatch):
    """Set a layout's knobs for the test (the port reads them when it
    builds a table)."""
    def set_layout(name):
        for k, v in LAYOUTS[name][0].items():
            monkeypatch.setenv(k, v)
    return set_layout


def _host_scene(name):
    with pytest.MonkeyPatch.context() as mp:
        for k, v in LAYOUTS[name][0].items():
            mp.setenv(k, v)
        return build_fast_scene_from_arrays(*_arrays(), device="cpu")


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_host_tables_match_jax(refs, name):
    _, ref, _ = refs
    scene = _host_scene(name)
    assert scene.layout == LAYOUTS[name][1]
    assert_scene_tables(scene, ref[name]["frames"], "scene_")
    cs, w = scene.layout
    assert scene.node_rows.shape[1] == 16 * w
    assert scene.cluster_counts.shape[0] == scene.clusters.shape[0] * 8 // cs
    assert int(scene.cluster_counts.sum()) == scene.num_triangles
    assert int(scene.cluster_counts.max()) == cs


@pytest.mark.parametrize("name", FULL)
def test_instanced_tables_match_jax(refs, layout_env, name):
    inp, ref, _ = refs
    layout_env(name)
    blases = [instanced.prep_mesh_blas(m, device="cpu") for m in _meshes()]
    assert {b.layout for b in blases} == {LAYOUTS[name][1]}
    k = len(INSTANCE_KS)
    fs = instanced.combine_instanced(
        [blases[i] for i in INSTANCE_KS],
        torch.from_numpy(inp["instanced"][f"params_{k}"]))
    assert fs.layout == LAYOUTS[name][1]
    assert_scene_tables(fs, ref[name]["instanced"], f"k{k}_")


@pytest.mark.parametrize("name", CLUSTER)
def test_refit_tables_match_jax(refs, layout_env, name):
    inp, ref, _ = refs
    layout_env(name)
    meshes = [inp["refit"]["mesh_0"], inp["refit"]["mesh_1"]]
    params = [(p[0:3], p[3:6], p[6:9], p[9]) for p in REFIT_PARAMS]
    got = refit.capture_tables(meshes, params, method="sah")
    want = ref[name]["refit"]
    for t in refit.TABLES:
        assert got[t].tobytes() == want[f"sah_cap_{t}"].tobytes(), t
    rs = refit.capture_refit(meshes, params, method="sah", device="cpu")
    fs = rs.refit(params)
    assert fs.layout == LAYOUTS[name][1]
    assert_scene_tables(fs, want, "sah_params_")


def test_refit_refuses_width_16(layout_env):
    """The capture emits 8-wide tables only, as the JAX capture asserts:
    under ``RAYTPU_WIDE=16`` it raises the ``ValueError`` that the device
    builder takes as "no capture"."""
    layout_env("w16")
    params = [(p[0:3], p[3:6], p[6:9], p[9]) for p in REFIT_PARAMS]
    with pytest.raises(ValueError, match="RAYTPU_WIDE=16"):
        refit.capture_tables(_meshes()[1:], params)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_lbvh_tables_match_jax(refs, layout_env, name):
    inp, ref, _ = refs
    layout_env(name)
    fs = build_fast_scene_device(
        *(torch.from_numpy(inp["lbvh_scene"][k]) for k in ("verts", "mats")))
    assert fs.layout == LAYOUTS[name][1]
    assert (fs.nodes4 is None) == (LAYOUTS[name][1][1] == 16)
    assert_scene_tables(fs, ref[name]["lbvh_scene"], "lbvh_")


def _ray_args(rays, active):
    rays = torch.from_numpy(np.ascontiguousarray(rays))
    return rays, torch.from_numpy(np.asarray(active))


def _assert_hits(scene, got, want, rays, active, cfg):
    assert got[0].tobytes() == want[0].tobytes(), "t must be bit-equal"
    differ = torch.from_numpy((got != want).any(0))
    ties = tie_lanes(scene, rays[0:3], rays[3:6], active, cfg)
    assert not (differ & ~ties).any(), "difference on a non-tie lane"
    assert int(differ.sum()) < 0.01 * P
    assert 0.1 < (got[0] < cfg.t_max).mean() < 0.99


@pytest.mark.parametrize("rays", ["rand", "prim"])
@pytest.mark.parametrize("name", FULL)
def test_trace4_plain_matches_pallas(refs, name, rays):
    inp, ref, _ = refs
    scene = _host_scene(name)
    cfg = RenderConfig()
    r, a = _ray_args(inp["trace"][f"{rays}_rays"],
                     inp["trace"][f"{rays}_active"])
    launches.reset()
    got = trace4_plain(scene, r, a, cfg).numpy()
    assert dict(launches.plain) == {f"trace4_{name}": 1}
    _assert_hits(scene, got, ref[name]["trace"][f"{rays}_out"], r, a, cfg)


@pytest.mark.parametrize("name", CLUSTER)
def test_binary_walk_plain_matches_pallas(refs, name):
    inp, ref, _ = refs
    scene = _host_scene(name)
    cfg = RenderConfig()
    r, a = _ray_args(inp["binary"]["rays"], inp["binary"]["active"])
    launches.reset()
    got = trace2_plain(scene, r, a, cfg).numpy()
    assert dict(launches.plain) == {f"trace2_{name}": 1}
    _assert_hits(scene, got, ref[name]["trace_shadings"]["path_out"], r, a,
                 cfg)


@pytest.mark.parametrize("state", ["uniform", "budget"])
@pytest.mark.parametrize("name", FULL)
def test_bounce12_plain_matches_pallas(refs, name, state):
    """Kernel B's plain version at bcap 1 against the JAX interpret
    kernel: seeds, alive flags, budgets, keys and counts exact, floats
    within 2e-5, on every lane whose walk is not an equal-t tie."""
    inp, ref, _ = refs
    scene = _host_scene(name)
    cfg = RenderConfig()
    f, i = inp["bounce"][f"{state}_f"], inp["bounce"][f"{state}_i"]
    launches.reset()
    out, key, counts = bounce12_plain(scene, _port_state(f, i), 1, True, cfg)
    assert dict(launches.plain) == {f"bounce12_{name}": 1}
    got_f = np.concatenate([out[0:9].view(torch.float32).numpy(),
                            (out[ROW_ALIVE] != 0).numpy()[None]
                            .astype(np.float32)])
    got_i = np.stack([out[ROW_SEED].numpy(), out[ROW_BUDGET].numpy(),
                      key.numpy()])
    want = ref[name]["bounce"]
    differ = ((np.abs(got_f - want[f"{state}_f"]) > 2e-5).any(0)
              | (got_i != want[f"{state}_i"]).any(0))
    ties = tie_lanes(scene, [torch.from_numpy(f[j]) for j in range(3)],
                     [torch.from_numpy(f[j]) for j in range(3, 6)],
                     torch.from_numpy(f[9] > 0.5), cfg).numpy()
    assert not (differ & ~ties).any(), np.nonzero(differ & ~ties)[0][:10]
    assert differ.sum() < 0.01 * P
    if not differ.any():
        assert int(counts[0]) == want[f"{state}_rays"]
        assert int(counts[1]) == want[f"{state}_live"]
    assert 0 < int(counts[1]) < int(counts[0])


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_frame_matches_jax(refs, name):
    """The XLA render path's 64x32 frame (two bands, four bounces) of the
    port's own scene against the JAX Renderer's."""
    _, ref, frames = refs
    want = ref[name]["frames"]
    scene, cfg, uni, accum, image, rays, plain = frames[name]
    np.testing.assert_array_equal(uni.origin.numpy(),
                                  _sub(want, "cam0_")["origin"])
    assert plain == {cuda_build.kernel_name(
        "mega", cuda_build.leaf_layout(scene.layout)), "tonemap"}
    np.testing.assert_allclose(accum, want["accum_0"], rtol=0, atol=2e-5)
    differ = (image != want["image_0"]).any(-1)
    ties = _bounce0_tie_pixels(scene, cfg, uni)
    assert not (differ & ~ties).any(), np.argwhere(differ & ~ties)[:10]
    assert differ.mean() <= 0.005
    assert rays == int(want["rays_0"])
    assert accum.max() > 0
