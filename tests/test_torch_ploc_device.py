"""The port's device PLOC tree (``bvh/ploc_device.py``) against the JAX
package's.

One JAX child process (``torch_jax_refs.run_jobs``, eager XLA, no Pallas)
runs ``jax.jit(build_fast_scene_device_ploc)`` on five soups made here
from a numpy seed, each zero-padded to 512 triangles as the device builder
pads a scene to its capacity bucket: the cube, icosphere and plane of
``tests/test_lbvh.py``, a random soup, a tie soup of one repeated
triangle (equal costs merge one pair a round, so phase 1 ends above LCAP
leaves and the force-fit valve runs, and phase 2 runs past its 48 SA
rounds into forced halving), the random soup moved (an edit at the same
capacity) and the random soup scaled to 1e20 but for four triangles, whose
union areas overflow to inf (after one SA round no mutual pair forms, so
phase 2 stalls and halves by the parity of an odd step). The
tables must equal JAX's: link and meta words and every float bit-equal,
the unit normals within 2 ulp, and equal counts.
"""

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.bvh import ploc_device
from raytracer_tpu_torch.bvh.lbvh import pad_to_cluster_multiple
from raytracer_tpu_torch.core.camera import Camera
from raytracer_tpu_torch.core.fast_types import LEAF_CID_BITS, LEAF_CID_MASK
from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.kernels.packet import render_linear_fast
from raytracer_tpu_torch.scene.builder import build_fast_scene_from_arrays
from raytracer_tpu_torch.utils import assets
from torch_jax_refs import assert_scene_tables, run_jobs

torch.set_num_threads(2)

T = 512
SOUPS = ("cube_plane", "random", "ties", "moved", "huge")


def _cube_plane():
    """``tests/test_lbvh.py``'s scene arrays (334 triangles)."""
    cube = assets.make_cube() * 4.0 + np.array([0, -6, 0], np.float32)
    sphere = assets.make_icosphere(2, 3.0) + np.array([6, -3, 2], np.float32)
    plane = (assets.make_ground_plane() * np.array([150, 1, 150], np.float32)
             + np.array([0, -10, 0], np.float32))
    verts = np.concatenate([plane, cube, sphere]).astype(np.float32)
    mats = np.zeros((verts.shape[0], 4), np.float32)
    mats[:2, 0:3] = (0.5, 0.5, 0.5)
    mats[2:14, 0:3] = (1.0, 0.2, 0.2)
    mats[14:, 0:3] = (0.7, 0.7, 0.2)
    mats[14:, 3] = 1.0
    return verts, mats


def _pad(verts, mats):
    pad = T - verts.shape[0]
    return (np.concatenate([verts, np.zeros((pad, 3, 3), np.float32)]),
            np.concatenate([mats, np.zeros((pad, 4), np.float32)]))


def _soups() -> dict:
    r = np.random.default_rng(23)
    n = 500
    centers = r.uniform(-20, 20, (n, 1, 3))
    rand_v = (centers + r.uniform(-2, 2, (n, 3, 3))).astype(np.float32)
    rand_m = np.concatenate([r.uniform(0.1, 0.9, (n, 3)),
                             r.integers(0, 4, (n, 1))], 1).astype(np.float32)
    base = r.uniform(-5, 5, (3, 3, 3)).astype(np.float32)
    tie_v = np.tile(base[:1], (510, 1, 1))
    tie_m = np.tile(rand_m[:1], (510, 1))
    huge_v = (rand_v * np.float32(5e18)).astype(np.float32)
    huge_v[:4] = rand_v[:4]
    return {"cube_plane": _pad(*_cube_plane()),
            "random": _pad(rand_v, rand_m),
            "ties": _pad(tie_v, tie_m),
            "moved": _pad(rand_v + np.float32([0.0, 2.0, 0.0]), rand_m),
            "huge": _pad(huge_v, rand_m)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    soups = _soups()
    inp = {"soups": np.array(SOUPS)}
    for name, (v, m) in soups.items():
        inp[f"verts_{name}"], inp[f"mats_{name}"] = v, m
    (out,) = run_jobs([("ploc_device", inp, None)],
                      tmp_path_factory.mktemp("ploc"))
    built = {name: ploc_device.build_fast_scene_device_ploc(
        torch.from_numpy(v), torch.from_numpy(m))
        for name, (v, m) in soups.items()}
    return soups, out, built


@pytest.mark.parametrize("name", SOUPS)
def test_tables_match_jax(ref, name):
    _, out, built = ref
    assert_scene_tables(built[name], out, f"{name}_")


@pytest.mark.parametrize("name", SOUPS)
def test_wide_leaves_cover_every_triangle_once(ref, name):
    """``tests/test_lbvh.py:295-325``: the wide table's leaf metas name
    each leaf once, with fills 1..8 summing to the padded count."""
    _, _, built = ref
    fs = built[name]
    wide = fs.nodes4.numpy()[:fs.num_nodes4]
    metas = wide.reshape(-1, 8, 16)[:, :, 6].astype(np.int64)
    enc = -metas[metas < 0] - 1
    cids = enc & LEAF_CID_MASK
    cnts = (enc >> LEAF_CID_BITS) + 1
    assert len(np.unique(cids)) == len(cids)
    assert cnts.min() >= 1 and cnts.max() <= 8
    assert cnts.sum() == T


def _phase_2(verts, lcap: int = T // 4):
    """The build's phases on a soup -> (live leaves L, phase 2's steps,
    phase 2's steps with no mutual pair)."""
    lo, hi, _ = ploc_device._sorted_boxes(torch.from_numpy(verts))
    lc, box, _, _ = ploc_device._cluster_leaves(lo, hi, lcap)
    _, _, it, stalls = ploc_device._merge_to_root(lc, box[:lcap], lcap)
    return int(lc), int(it), int(stalls)


def test_tie_soup_runs_both_valves(ref, monkeypatch):
    """Equal costs merge one pair a round: phase 1 ends above LCAP leaves,
    so the force-fit valve runs, and phase 2 runs past _FORCE_AFTER SA
    rounds, so its forced halving runs."""
    soups, _, _ = ref
    v, _ = soups["ties"]
    lo, hi, _ = ploc_device._sorted_boxes(torch.from_numpy(v))
    lcap = T // 4
    monkeypatch.setattr(ploc_device, "_MAX_FORCE", 0)
    n_capped = int(ploc_device._cluster_leaves(lo, hi, lcap)[0])
    monkeypatch.undo()
    n_forced = int(ploc_device._cluster_leaves(lo, hi, lcap)[0])
    assert n_capped > lcap >= n_forced
    lc, steps, stalls = _phase_2(v)
    assert lc == n_forced and steps > ploc_device._FORCE_AFTER
    assert stalls == 0


@pytest.mark.parametrize("name,late,stalled", [
    ("random", False, False), ("ties", True, False), ("huge", False, True)])
def test_phase_2_exits(ref, name, late, stalled):
    """Phase 2 ends by SA rounds alone (random), reaches forced halving
    at _FORCE_AFTER steps (ties) or stalls with no mutual pair and halves
    at once (huge: its union areas overflow to inf). Each of these soups
    matches JAX's tables (``test_tables_match_jax``)."""
    soups, _, built = ref
    lc, steps, stalls = _phase_2(soups[name][0])
    assert 2 * lc - 1 == built[name].num_nodes
    assert (steps > ploc_device._FORCE_AFTER) == late
    assert (stalls > 0) == stalled
    assert steps < ploc_device._MAX_ROOT


def test_renders_like_the_host_sah_table():
    """A 32x24 frame through the PLOC table and through the host SAH
    table: different trees, the same closest hits
    (``tests/test_lbvh.py:276-293``)."""
    verts, mats = _cube_plane()
    host = build_fast_scene_from_arrays(verts, mats, device="cpu")
    pv, pm = pad_to_cluster_multiple(verts, mats)
    dev = ploc_device.build_fast_scene_device_ploc(torch.from_numpy(pv),
                                                   torch.from_numpy(pm))
    cfg = RenderConfig(width=32, height=24)
    cam = Camera(origin=(-10.0, 6.0, 30.0), look_at=(0.0, -6.0, 0.0),
                 vfov_deg=40.0, aspect_ratio=32 / 24).uniforms(device="cpu")
    a = render_linear_fast(host, cam, cfg)[0]
    b = render_linear_fast(dev, cam, cfg)[0]
    assert a.abs().max() > 0
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=3e-5)


def test_ploc_refuses_a_tree_past_the_stack(ref, monkeypatch):
    soups, _, _ = ref
    v, m = soups["random"]
    monkeypatch.setattr(ploc_device, "STACK_CAP", 8)
    with pytest.raises(ValueError, match="STACK_CAP"):
        ploc_device.build_fast_scene_device_ploc(torch.from_numpy(v),
                                                 torch.from_numpy(m))


def test_ploc_needs_a_row_multiple_and_16_triangles():
    v, m = _cube_plane()
    with pytest.raises(ValueError, match="cluster-row"):
        ploc_device.build_fast_scene_device_ploc(torch.from_numpy(v[:9]),
                                                 torch.from_numpy(m[:9]))
    with pytest.raises(ValueError, match="16 triangles"):
        ploc_device.build_fast_scene_device_ploc(torch.from_numpy(v[:8]),
                                                 torch.from_numpy(m[:8]))
