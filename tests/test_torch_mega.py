"""The plain versions of the JAX package's XLA walks and megakernel
(``kernels/packet.py``) against the JAX functions. The frames of the XLA
render path (``RAYTPU_BOUNCE=mega``, ``RAYTPU_B0=mega|packet|pwave`` and
the fixed-light tier with ``RAYTPU_B0=mega``) are held to the JAX
Renderer in ``tests/test_torch_paths.py``, beside the other paths.

The same seeded inputs go through the JAX functions (XLA only: no Pallas
kernel runs on these paths, so no interpret lowering) and the port's:

* ``ray_traverse_fast`` on 2048 random rays, a tenth inactive, under path
  and fixed-light shading, and ``packet_traverse`` on 32 groups of 64 rays
  (the 8x8-tile shape of ``RAYTPU_B0=packet``), every fifth group
  inactive;
* ``megakernel_bounces`` from bounce 0 and from bounce 1 on 1024 rays,
  pixel ids a permutation, ``RAYTPU_COMPACT_FLOOR=256`` (levels 1024, 512,
  256), with the clone-slot case of the JAX package's tests in the state:
  ray 0 is dead at entry with colour (7, 0, 0), and its clones in the
  compacted levels must not deposit it again.

Tolerances: hit masks and ``rays_traced`` equal; floats within 2e-5; a
lane may differ only where its first closest hit is an equal-t tie
(``tie_lanes``), at most 0.5% of lanes. The compaction levels change no
byte of the port's megakernel (any floor and ratio).

The JAX references come from one child process (``run_jobs``, with the
tile-shape knob ``RAYTPU_TRAVERSE_UNROLL=1``, which changes no result and
halves the XLA loop bodies it compiles); the port's results are computed
while it runs.
"""

import threading

import numpy as np
import pytest
import torch

from test_torch_renderer import _two_cubes
from torch_jax_refs import assert_scene_tables, run_jobs, tie_lanes

from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.kernels import launches, mega, packet
from raytracer_tpu_torch.scene.builder import build_fast_scene_from_arrays
from raytracer_tpu_torch.utils import assets

torch.set_num_threads(2)

P = 2048
PM = 1024
NG = 32
COMPACT = {"RAYTPU_COMPACT_FLOOR": "256", "RAYTPU_COMPACT_RATIO": "2"}
LEVELS = (("1000000000", "2"), ("16", "3"), ("64", "1"))


def _scene_arrays():
    """The two cubes and a fuzzy-metal icosphere (346 triangles)."""
    verts, mats = _two_cubes()
    ball = assets.make_icosphere(2, 3.0) + np.array([-7, -4, 3], np.float32)
    bmat = np.tile(np.array([[0.9, 0.8, 0.3, 2.0]], np.float32),
                   (ball.shape[0], 1))
    return (np.concatenate([verts, ball]).astype(np.float32),
            np.concatenate([mats, bmat]))


def _rays(rng, n):
    o = rng.uniform(-15, 15, (3, n)).astype(np.float32)
    o[1] = rng.uniform(-8, 10, n)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return np.concatenate([o, d]).astype(np.float32)


def _inputs():
    rng = np.random.default_rng(9)
    verts, mats = _scene_arrays()
    g_active = rng.uniform(size=(64, NG)) < 0.8
    g_active[:, ::5] = False
    m_f = np.concatenate([_rays(rng, PM), rng.uniform(0, 0.5, (3, PM)),
                          rng.uniform(0.3, 1, (3, PM))]).astype(np.float32)
    m_alive = rng.uniform(size=PM) < 0.85
    m_f[6:9, m_alive] = 0.0
    # The clone-slot case: ray 0 dead at entry, carrying colour 7.
    m_alive[0] = False
    m_f[6:9, 0] = (7.0, 0.0, 0.0)
    mega_inp = dict(
        verts=verts, mats=mats, rays=_rays(rng, P),
        active=rng.uniform(size=P) < 0.9,
        g_rays=_rays(rng, 64 * NG).reshape(6, 64, NG), g_active=g_active,
        m_f=m_f, m_seed=rng.integers(0, 2 ** 32, PM, dtype=np.uint32),
        m_alive=m_alive, m_pix=rng.permutation(PM).astype(np.int32),
        sky=True, starts=np.array([0, 1]), cfg_width=16, cfg_height=16,
        cfg_max_bounces=10)
    return mega_inp


def _v3(a):
    return tuple(torch.from_numpy(np.ascontiguousarray(c)) for c in a)


def _mega_state(inp):
    m = inp["m_f"]
    seed = torch.from_numpy(inp["m_seed"].astype(np.int64))
    return (_v3(m[0:3]), _v3(m[3:6]), _v3(m[6:9]), _v3(m[9:12]), seed,
            torch.from_numpy(inp["m_alive"]))


def _mega_cfg():
    return RenderConfig(width=16, height=16, max_bounces=10)


def _port_results(inp) -> dict:
    """Every port-side result of the module, with the plain versions it
    booked."""
    scene = build_fast_scene_from_arrays(inp["verts"], inp["mats"],
                                         device="cpu")
    got = {"scene": scene}
    o, d = _v3(inp["rays"][0:3]), _v3(inp["rays"][3:6])
    active = torch.from_numpy(inp["active"])
    for shading in ("path", "fixed_light"):
        cfg = RenderConfig(width=16, height=16, shading=shading)
        launches.reset()
        got[f"fast_{shading}"] = packet._traverse_fast(scene, o, d, active,
                                                       cfg)
        got[f"fast_{shading}_plain"] = dict(launches.plain)
        got[f"fast_{shading}_ties"] = tie_lanes(scene, o, d, active,
                                                cfg).numpy()
    g = inp["g_rays"]
    go, gd = _v3(g[0:3]), _v3(g[3:6])
    g_active = torch.from_numpy(inp["g_active"])
    cfg = RenderConfig(width=16, height=16)
    got["packet"] = packet.packet_traverse(scene, go, gd, g_active, cfg)
    flat = lambda v: tuple(c.reshape(-1) for c in v)
    got["packet_ties"] = tie_lanes(scene, flat(go), flat(gd),
                                   g_active.reshape(-1), cfg).numpy()
    got["packet_per_ray"] = packet.ray_traverse_fast(
        scene, flat(go), flat(gd), g_active.reshape(-1), cfg)

    state = _mega_state(inp)
    pix = torch.from_numpy(inp["m_pix"])
    mcfg = _mega_cfg()
    got["mega_ties"] = tie_lanes(scene, state[0], state[1], state[5],
                                 mcfg).numpy()
    with pytest.MonkeyPatch.context() as mp:
        for k, v in COMPACT.items():
            mp.setenv(k, v)
        for s in (0, 1):
            launches.reset()
            got[f"mega{s}"] = mega.mega(scene, *state, True, mcfg,
                                        start_bounce=s, pix=pix)
            got[f"mega{s}_plain"] = dict(launches.plain)
    for floor, ratio in LEVELS:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("RAYTPU_COMPACT_FLOOR", floor)
            mp.setenv("RAYTPU_COMPACT_RATIO", ratio)
            got[("levels", floor, ratio)] = packet.megakernel_bounces(
                scene, *state, True, mcfg, start_bounce=1, pix=pix,
                walks=True)

    return got


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    mega_inp = _inputs()
    jobs = [("mega", mega_inp, COMPACT)]
    box = {}

    def child():
        try:
            box["refs"] = run_jobs(jobs, tmp_path_factory.mktemp("mega"),
                                   env={"RAYTPU_TRAVERSE_UNROLL": "1"})
        except Exception as e:  # re-raised below, in the test's thread
            box["error"] = e

    th = threading.Thread(target=child)
    th.start()
    try:
        got = _port_results(mega_inp)
    finally:
        th.join()
    if "error" in box:
        raise box["error"]
    ref = box["refs"][0]
    # Both sides built the same tables.
    assert_scene_tables(got["scene"], ref, "scene_")
    return mega_inp, ref, got


def _assert_result(res, want, hit, ties, atol=2e-5):
    got = torch.stack([res.closest_t, *res.normal, *res.mat_albedo,
                       res.mat_type]).numpy()
    assert np.array_equal(res.hit.numpy(), hit)
    differ = (np.abs(got - want) > atol).any(0)
    assert not (differ & ~ties).any(), np.argwhere(differ & ~ties)[:10]
    assert differ.mean() <= 0.005


@pytest.mark.parametrize("shading", ["path", "fixed_light"])
def test_ray_traverse_fast_matches_jax(case, shading):
    inp, ref, got = case
    res = got[f"fast_{shading}"]
    assert got[f"fast_{shading}_plain"] == {"trace2": 1}
    _assert_result(res, ref[f"fast_{shading}"], ref[f"fast_{shading}_hit"],
                   got[f"fast_{shading}_ties"])
    active = torch.from_numpy(inp["active"])
    assert res.hit.any() and (~res.hit & active).any()


@pytest.mark.parametrize("shading", ["path", "fixed_light"])
def test_port_walks_agree(case, shading):
    """The per-ray walks the kernels stand for agree with the JAX-form
    walk lane by lane: the binary walk of ``trace2`` (slot order, live
    triangles, the flip at the end) gives ``ray_traverse_fast``'s hit
    exactly, ties included; the 8-wide walk of ``trace4`` the same t."""
    from raytracer_tpu_torch.kernels.trace import trace2_plain, trace4_plain

    inp, _, got = case
    scene = got["scene"]
    cfg = RenderConfig(width=16, height=16, shading=shading)
    rays = torch.from_numpy(inp["rays"])
    active = torch.from_numpy(inp["active"])
    res = got[f"fast_{shading}"]
    want = torch.stack([res.closest_t, *res.normal, *res.mat_albedo,
                        res.mat_type])
    assert (trace2_plain(scene, rays, active, cfg) == want).all()
    assert torch.equal(trace4_plain(scene, rays, active, cfg)[0],
                       res.closest_t)


def test_packet_traverse_matches_jax(case):
    _, ref, got = case
    res = got["packet"]
    _assert_result(res, ref["packet"], ref["packet_hit"],
                   got["packet_ties"])
    # The group walk and the per-ray walk give the same closest hit.
    assert torch.equal(got["packet_per_ray"].closest_t, res.closest_t)


@pytest.mark.parametrize("start", [0, 1])
def test_megakernel_matches_jax(case, start):
    inp, ref, got = case
    col, rays = got[f"mega{start}"]
    assert got[f"mega{start}_plain"] == {"mega": 1}
    assert int(rays) == int(ref[f"mega{start}_rays"])
    # Deposits land at the pixel ids: map the rays' ties there.
    ties = np.zeros(PM, bool)
    ties[inp["m_pix"]] = got["mega_ties"]
    want = ref[f"mega{start}_color"]
    differ = (np.abs(col.numpy() - want) > 2e-5).any(0)
    assert not (differ & ~ties).any(), np.argwhere(differ & ~ties)[:10]
    assert differ.mean() <= 0.005
    # The clone-slot case: ray 0's colour deposited once, exactly.
    assert col[:, inp["m_pix"][0]].tolist() == [7.0, 0.0, 0.0]
    assert col.abs().max() > 0


def test_compaction_levels_change_no_byte(case):
    _, _, got = case
    runs = [got[("levels", f, r)] for f, r in LEVELS]
    col0, rays0, walks0 = runs[0]
    for col, rays, walks in runs[1:]:
        assert col.numpy().tobytes() == col0.numpy().tobytes()
        assert int(rays) == int(rays0) and torch.equal(walks, walks0)
    # Rays traced: the live rays plus every respawn, i.e. the walks run.
    assert int(rays0) == int(walks0.sum()) > 0
    # The levels equal the megakernel call at the module's levels.
    assert col0.numpy().tobytes() == got["mega1"][0].numpy().tobytes()
