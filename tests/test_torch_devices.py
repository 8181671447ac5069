"""The port's entry points put their tensors on the card unless told
otherwise.

Each builder of scene tables or camera uniforms, called with no device,
targets ``"cuda"``: on a machine without a card it raises instead of
quietly handing back CPU tensors (on which every kernel wrapper would run
its plain version); with a card its tensors lie there. Only the CPU tests
pass ``device="cpu"``. The profiling app refuses to run without a card.
"""

import os

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.core.camera import Camera
from raytracer_tpu_torch.core.types import CameraUniforms
from raytracer_tpu_torch.scene import builder, presets
from raytracer_tpu_torch.scene.device_builder import DeviceSceneBuilder
from raytracer_tpu_torch.scene.scene import ModelInstance
from raytracer_tpu_torch.utils import assets


def _tris():
    verts = assets.make_cube().astype(np.float32)
    mats = np.full((verts.shape[0], 4), 0.5, np.float32)
    return verts, mats


def _scene_leaves():
    scene = builder.build_fast_scene_from_arrays(*_tris(), device="cpu")
    return {"nodes8": scene.nodes8.numpy(),
            "clusters": scene.clusters.numpy(),
            "nodes4": scene.nodes4.numpy(), "num_nodes": scene.num_nodes,
            "num_triangles": scene.num_triangles,
            "num_nodes4": scene.num_nodes4}


def _camera_leaves():
    uni = Camera((0.0, 1.0, 5.0), (0.0, 0.0, 0.0)).uniforms(device="cpu")
    return {"origin": uni.origin.numpy(),
            "lower_left_corner": uni.lower_left_corner.numpy(),
            "horizontal": uni.horizontal.numpy(),
            "vertical": uni.vertical.numpy(), "frame_count": 3,
            "sky_enabled": 1, "exposure": 0.0}


def _cube_obj():
    """A cube .obj in the working directory (the test's tmp_path)."""
    assets.write_obj("cube.obj", assets.make_cube())
    return os.path.abspath("cube.obj")


def _gpu_leaves():
    scene = builder.build_gpu_scene_from_arrays(*_tris(), device="cpu")
    leaves = {k: getattr(scene.bvh, k).numpy() for k in (
        "node_min", "node_max", "node_tri", "node_skip", "node_data",
        "node_count")}
    leaves.update(tri_verts=scene.tri_verts.numpy(),
                  materials=scene.materials.numpy(),
                  num_triangles=scene.num_triangles,
                  num_nodes=scene.num_nodes)
    return leaves


ENTRY_POINTS = {
    "CameraUniforms.create": lambda: CameraUniforms.create(
        (0, 0, 0), (-1, -1, -1), (2, 0, 0), (0, 2, 0)).origin,
    "Camera.uniforms": lambda: Camera(
        (0.0, 1.0, 5.0), (0.0, 0.0, 0.0)).uniforms().horizontal,
    "build_fast_scene_from_arrays": lambda: builder
    .build_fast_scene_from_arrays(*_tris()).nodes4,
    "fast_scene_from_numpy": lambda: builder.fast_scene_from_numpy(
        _scene_leaves()).clusters,
    "camera_uniforms_from_numpy": lambda: builder
    .camera_uniforms_from_numpy(_camera_leaves()).frame_count,
    "flagship_scene": lambda: presets.flagship_scene().nodes8,
    "build_fast_scene": lambda: builder.build_fast_scene(
        [ModelInstance(_cube_obj())]).clusters,
    "build_gpu_scene": lambda: builder.build_gpu_scene(
        [ModelInstance(_cube_obj())]).tri_verts,
    "build_gpu_scene_from_arrays": lambda: builder
    .build_gpu_scene_from_arrays(*_tris()).bvh.node_min,
    "gpu_scene_from_numpy": lambda: builder.gpu_scene_from_numpy(
        _gpu_leaves()).materials,
    "DeviceSceneBuilder.build": lambda: DeviceSceneBuilder().build(
        [ModelInstance(_cube_obj())]).nodes4,
}


@pytest.fixture
def has_card():
    return torch.cuda.is_available()


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(monkeypatch, tmp_path, has_card,
                                          name):
    monkeypatch.chdir(tmp_path)
    # A small stand-in for the 49k-triangle flagship mesh.
    monkeypatch.setattr(presets, "flagship_arrays",
                        lambda search=(): (*_tris(), "cube"))
    make = ENTRY_POINTS[name]
    if has_card:
        assert make().device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError),
                           match="CUDA|cuda"):
            make()


def test_profile_app_needs_a_card(has_card):
    from raytracer_tpu_torch.apps import profile

    with pytest.raises(SystemExit):
        profile.main(["--paths", "nonsense"] if has_card else ["--help"])
    if not has_card:
        with pytest.raises(RuntimeError, match="CUDA"):
            profile.main(["--paths", "default"])


def test_profile_busy_time_is_the_union_of_intervals():
    from raytracer_tpu_torch.apps.profile import _busy_us

    assert _busy_us([]) == 0.0
    assert _busy_us([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17.0


def test_packed_counting_build_refuses_cpu_tensors():
    """The packed kernel's counting build has no plain version: on CPU
    tensors it raises instead of counting nothing."""
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.kernels.bounce import bounce_packed_count

    scene = builder.build_fast_scene_from_arrays(*_tris(), device="cpu")
    sf = torch.zeros((13, 4))
    si = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="card"):
        bounce_packed_count(scene, sf, si, 1, True, RenderConfig())
