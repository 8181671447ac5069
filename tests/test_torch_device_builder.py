"""The port's live-edit builder (``scene/device_builder.py``) on the CPU.

Port-only, as the JAX package's own tests check its builder
(``tests/test_lbvh.py:224``, ``tests/test_refit.py:136-190``,
``tests/test_instanced.py:160-210``): each mode builds what it says and
renders what a host build of the same soup renders, edits move boxes,
fallbacks go instanced -> refit -> lbvh, and a refused knob or an error
of the card passes through every fallback.
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.core.camera import Camera
from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.engine.renderer import Renderer
from raytracer_tpu_torch.scene import device_builder, instanced
from raytracer_tpu_torch.scene.builder import build_fast_scene
from raytracer_tpu_torch.scene.device_builder import DeviceSceneBuilder
from raytracer_tpu_torch.scene.scene import ModelInstance
from raytracer_tpu_torch.utils import assets

torch.set_num_threads(2)

MODES = ("instanced", "refit", "lbvh")


@pytest.fixture(scope="module")
def objs(tmp_path_factory):
    d = tmp_path_factory.mktemp("objs")
    paths = {}
    for name, tris in (("cube", assets.make_cube()),
                       ("terrain", assets.make_terrain(n=12)),
                       ("plane", assets.make_ground_plane())):
        paths[name] = str(d / f"{name}.obj")
        assets.write_obj(paths[name], tris)
    return paths


def _instances(objs):
    return [
        ModelInstance(objs["terrain"], "ground", position=(0, -5, 0),
                      scale=(30, 1, 30), color=(0.5, 0.5, 0.5)),
        ModelInstance(objs["cube"], "c0", position=(0, -2, 0),
                      scale=(4, 4, 4), color=(0.8, 0.3, 0.3)),
        ModelInstance(objs["cube"], "c1", position=(6, 0, 2),
                      scale=(-2, 2, 2), color=(0.3, 0.6, 0.8),
                      material_type=1.0),
    ]


def _linear(scene):
    cfg = RenderConfig(width=32, height=24, max_bounces=2)
    cam = Camera(origin=(-10.0, 6.0, 30.0), look_at=(0.0, -2.0, 0.0),
                 vfov_deg=40.0, aspect_ratio=32 / 24)
    accum, _, _ = Renderer(cfg).render(scene, cam.uniforms(device="cpu"))
    return accum.numpy()


def _walk_terminates(scene):
    """The binary skip walk visits every row once and leaf ids are in
    range (link bits survived the f32 view)."""
    m = scene.num_nodes
    links = scene.nodes8[:, 6:8].numpy().view(np.int32)
    node = steps = 0
    while node < m and steps <= 4 * m:
        c = links[node, 1]
        node = (-c - 1) if c < 0 else links[node, 0]
        steps += 1
    leaves = links[:m][links[:m, 1] >= 0, 1]
    return node >= m and (leaves < scene.clusters.shape[0]).all()


@pytest.mark.parametrize("mode", MODES)
def test_each_mode_renders_like_a_host_build(objs, monkeypatch, mode):
    monkeypatch.setenv("RAYTPU_DEVICE_BUILD", mode)
    insts = _instances(objs)
    b = DeviceSceneBuilder(device="cpu")
    scene = b.build(insts)
    assert b.last_mode == mode
    host = build_fast_scene(insts, device="cpu")
    assert scene.num_triangles == host.num_triangles
    assert _walk_terminates(scene)
    np.testing.assert_allclose(_linear(scene), _linear(host), atol=3e-5)


@pytest.mark.parametrize("mode", MODES)
def test_edits_move_boxes_and_keep_shapes(objs, monkeypatch, mode):
    """A drag changes the tables, not their shapes; the same pose gives
    the same tables again."""
    monkeypatch.setenv("RAYTPU_DEVICE_BUILD", mode)
    insts = _instances(objs)
    b = DeviceSceneBuilder(device="cpu")
    s1 = b.build(insts)
    moved = list(insts)
    moved[-1] = dataclasses.replace(moved[-1], position=(9.0, 1.0, 2.0))
    s2 = b.build(moved)
    s3 = b.build(insts)
    bits = lambda s, name: getattr(s, name).view(torch.int32)
    for name in ("nodes8", "nodes4", "clusters"):
        assert bits(s1, name).shape == bits(s2, name).shape
        assert torch.equal(bits(s1, name), bits(s3, name)), name
    assert (bits(s1, "nodes8") != bits(s2, "nodes8")).any()
    assert s1.num_nodes == s2.num_nodes


def test_refit_mode_one_capture_many_edits(objs, monkeypatch):
    monkeypatch.setenv("RAYTPU_DEVICE_BUILD", "refit")
    insts = _instances(objs)[:1] + [ModelInstance(
        objs["terrain"], "b", position=(0, 5, 0), scale=(10, 1, 10))]
    b = DeviceSceneBuilder(device="cpu")
    s1 = b.build(insts)
    moved = [insts[0], dataclasses.replace(insts[1],
                                           position=(3.0, 5.0, 1.0))]
    s2 = b.build(moved)
    assert len(b._refit_cache) == 1
    cap = next(iter(b._refit_cache.values()))
    assert cap.edits == 2 and b.last_mode == "refit"
    assert (s1.nodes8[:, :6] - s2.nodes8[:, :6]).abs().max() > 0.5
    # RAYTPU_REFIT_REFRESH recaptures after that many edits.
    monkeypatch.setenv("RAYTPU_REFIT_REFRESH", "2")
    b.build(insts)
    assert next(iter(b._refit_cache.values())).edits == 1


def test_tiny_scene_refit_falls_back_to_lbvh(objs, monkeypatch):
    """A 2-triangle plane is one leaf: no capture, an LBVH instead."""
    monkeypatch.setenv("RAYTPU_DEVICE_BUILD", "refit")
    b = DeviceSceneBuilder(device="cpu")
    s = b.build([ModelInstance(objs["plane"], position=(0, -5, 0),
                               scale=(30, 1, 30))])
    assert not b._refit_cache and b.last_mode == "lbvh"
    assert s.num_triangles == 2


def test_past_64_instances_falls_back_to_refit(objs, monkeypatch):
    monkeypatch.delenv("RAYTPU_DEVICE_BUILD", raising=False)
    insts = [ModelInstance(objs["cube"], f"c{i}",
                           position=(3.0 * (i % 9), 3.0 * (i // 9), 0))
             for i in range(instanced.MAX_INSTANCES + 1)]
    b = DeviceSceneBuilder(device="cpu")
    s = b.build(insts)
    assert b.last_mode == "refit" and s.num_triangles == 12 * len(insts)
    assert b.build(insts[:instanced.MAX_INSTANCES]).num_triangles == \
        12 * instanced.MAX_INSTANCES and b.last_mode == "instanced"


def test_failed_strategy_falls_back(objs, monkeypatch):
    def fail(*a, **k):
        raise ValueError("no BLAS today")

    monkeypatch.setattr(device_builder, "combine_instanced", fail)
    b = DeviceSceneBuilder(device="cpu")
    assert b.build(_instances(objs)).num_triangles > 0
    assert b.last_mode == "refit"
    monkeypatch.setattr(device_builder, "capture_refit", fail)
    assert b.build(_instances(objs)[:2]).num_triangles > 0
    assert b.last_mode == "lbvh"


@pytest.mark.parametrize("error", [
    NotImplementedError("refused knob"),
    RuntimeError("CUDA error: an illegal memory access was encountered")],
    ids=["refusal", "cuda_error"])
def test_refusals_and_card_errors_pass_through(objs, monkeypatch, error):
    def fail(*a, **k):
        raise error

    monkeypatch.setattr(device_builder, "combine_instanced", fail)
    b = DeviceSceneBuilder(device="cpu")
    with pytest.raises(type(error)):
        b.build(_instances(objs))


@pytest.mark.parametrize("env", [
    {"RAYTPU_DEVICE_BUILD": "bvh"},
    {"RAYTPU_DEVICE_BUILD": "refit", "RAYTPU_DEVICE_TREE": "sah"}],
    ids=["unknown_build", "unknown_tree_through_fallback"])
def test_refused_knobs_raise(objs, monkeypatch, env):
    """An unknown build or tree raises; the tree knob is read where the
    LBVH builds, which the last case reaches only through the refit
    fallback (a one-leaf plane cannot be captured)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    b = DeviceSceneBuilder(device="cpu")
    with pytest.raises(NotImplementedError):
        b.build([ModelInstance(objs["plane"], scale=(30, 1, 30))])


@pytest.mark.parametrize("build,plane_only", [("lbvh", False),
                                              ("refit", True)],
                         ids=["lbvh", "refit_fallback"])
def test_ploc_tree_through_each_route(objs, monkeypatch, build, plane_only):
    """``RAYTPU_DEVICE_TREE=ploc`` builds the device PLOC tree on the
    LBVH route and on the refit mode's fallback (a one-leaf plane cannot
    be captured): ``last_mode`` "lbvh", the tables those of
    ``build_fast_scene_device_ploc`` on the assembled soup."""
    from raytracer_tpu_torch.bvh.ploc_device import \
        build_fast_scene_device_ploc
    from raytracer_tpu_torch.core.fast_types import ROW_TRIS
    from raytracer_tpu_torch.scene.builder import bucket

    monkeypatch.setenv("RAYTPU_DEVICE_BUILD", build)
    monkeypatch.setenv("RAYTPU_DEVICE_TREE", "ploc")
    insts = ([ModelInstance(objs["plane"], scale=(30, 1, 30))]
             if plane_only else _instances(objs))
    b = DeviceSceneBuilder(device="cpu")
    scene = b.build(insts)
    assert b.last_mode == "lbvh" and not b._refit_cache
    meshes = [b._mesh(inst.model_path) for inst in insts]
    total = sum(m.shape[0] for m in meshes)
    want = build_fast_scene_device_ploc(*device_builder._assemble(
        meshes, b._params(insts), bucket(-(-total // ROW_TRIS) * ROW_TRIS)))
    for name in ("nodes8", "nodes4", "clusters"):
        assert torch.equal(getattr(scene, name).view(torch.int32),
                           getattr(want, name).view(torch.int32)), name
    assert (scene.num_nodes, scene.num_nodes4, scene.num_triangles) == (
        want.num_nodes, want.num_nodes4, total)
    assert _walk_terminates(scene)
    if not plane_only:
        np.testing.assert_allclose(
            _linear(scene), _linear(build_fast_scene(insts, device="cpu")),
            atol=3e-5)


def test_missing_meshes_skip_and_empty_builds_on_the_host(objs):
    b = DeviceSceneBuilder(device="cpu")
    s = b.build([ModelInstance("/definitely/missing.obj"),
                 ModelInstance(objs["cube"], scale=(5, 5, 5))])
    assert s.num_triangles == 12 and b.last_mode == "instanced"
    empty = b.build([ModelInstance("/definitely/missing.obj")])
    assert empty.num_triangles == 0 and b.last_mode == "host_empty"


def test_params_cached_by_value(objs):
    b = DeviceSceneBuilder(device="cpu")
    insts = _instances(objs)
    p1 = b._params(insts)
    assert b._params(insts) is p1
    moved = insts[:2] + [dataclasses.replace(insts[2], color=(1, 1, 1))]
    assert b._params(moved) is not p1
    assert p1.shape == (3, 10) and p1[2, 0].item() == -2.0


def test_cuda_builder_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceSceneBuilder()
