"""The port's scene model, instance builder, .obj writer and presets
against the JAX package's, in-process (none of them computes through
XLA).

``ModelInstance`` and ``Scene`` JSON must equal the JAX dicts;
``gather_triangles`` soups, ``build_fast_scene`` tables and ``write_obj``
files must be byte-equal; a missing mesh is skipped with a warning; each
of the five presets must give the same instances (mesh file names aside:
each package caches its procedural meshes in its own dir), the same soup
bytes, camera uniforms, config, sky flag and exposure.
"""

import dataclasses
import json
import logging
import os
import tempfile

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.scene import builder, presets
from raytracer_tpu_torch.scene.scene import (ModelInstance, Scene,
                                             default_scene)
from raytracer_tpu_torch.utils import assets

torch.set_num_threads(2)

TABLES = ("nodes8", "clusters", "nodes4")
COUNTS = ("num_nodes", "num_triangles", "num_nodes4")


@pytest.fixture
def meshes(tmp_path):
    """A cube and an icosphere written by the JAX package's writer."""
    from raytracer_tpu.utils import assets as jax_assets

    cube, ball = tmp_path / "cube.obj", tmp_path / "ball.obj"
    jax_assets.write_obj(str(cube), jax_assets.make_cube())
    jax_assets.write_obj(str(ball), jax_assets.make_icosphere(2, 3.0))
    return str(cube), str(ball), str(tmp_path / "missing.obj")


def _instances(cls, cube, ball, missing):
    return [cls(cube, "Cube", position=(1, -6, 2), scale=(4, 2, 3),
                color=(1.0, 0.2, 0.2)),
            cls(missing, position=(0, 5, 0), material_type=3),
            cls(ball, "Ball", position=(9, -7, 2), color=(0.8, 0.8, 0.9),
                material_type=1.0)]


def test_model_instance_and_scene_json_equal_jax(meshes, tmp_path):
    from raytracer_tpu.scene.scene import ModelInstance as JaxInstance
    from raytracer_tpu.scene.scene import Scene as JaxScene

    ours = _instances(ModelInstance, *meshes)
    theirs = _instances(JaxInstance, *meshes)
    assert [i.to_json() for i in ours] == [i.to_json() for i in theirs]
    assert ours[1].display_name == "missing.obj"
    v = np.random.default_rng(3).standard_normal((5, 3, 3)).astype(
        np.float32)
    for a, b in zip(ours, theirs):
        assert a.transform(v).tobytes() == b.transform(v).tobytes()
    JaxScene(theirs).save_json(str(tmp_path / "jax.json"))
    Scene(ours).save_json(str(tmp_path / "port.json"))
    assert (tmp_path / "jax.json").read_bytes() == \
        (tmp_path / "port.json").read_bytes()
    back = Scene.load_json(str(tmp_path / "jax.json"))
    assert [i.to_json() for i in back.create_snapshot()] == \
        [i.to_json() for i in ours]
    assert len(back) == 3 and back.remove_at(1).material_type == 3.0


def test_default_scene_equals_jax(tmp_path):
    from raytracer_tpu.scene.scene import default_scene as jax_default

    for present in (False, True):
        if present:
            (tmp_path / "car.obj").write_text("v 0 0 0\n")
        ours = default_scene(str(tmp_path)).get_instances()
        theirs = jax_default(str(tmp_path)).get_instances()
        assert [i.to_json() for i in ours] == [i.to_json() for i in theirs]
        assert ours[1].model_path.endswith(
            "car.obj" if present else "white_mesh.obj")


def test_missing_mesh_is_skipped_with_a_warning(meshes, caplog):
    cube, _, missing = meshes
    with caplog.at_level(logging.WARNING, logger="raytpu.srt"):
        verts, mats = builder.gather_triangles(
            [ModelInstance(missing), ModelInstance(cube)])
    assert verts.shape == (12, 3, 3) and mats.shape == (12, 4)
    assert any("missing.obj" in r.getMessage() for r in caplog.records)
    with caplog.at_level(logging.WARNING, logger="raytpu.srt"):
        verts, mats = builder.gather_triangles([ModelInstance(missing)])
    assert verts.shape == (0, 3, 3) and mats.shape == (0, 4)


def test_gather_and_build_equal_jax(meshes):
    from raytracer_tpu.scene import builder as jax_builder
    from raytracer_tpu.scene.scene import ModelInstance as JaxInstance

    ours = builder.gather_triangles(_instances(ModelInstance, *meshes))
    theirs = jax_builder.gather_triangles(_instances(JaxInstance, *meshes))
    assert ours[0].shape == (12 + 320, 3, 3)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()

    got = builder.build_fast_scene(_instances(ModelInstance, *meshes),
                                   device="cpu")
    want = jax_builder.build_fast_scene(_instances(JaxInstance, *meshes))
    for name in TABLES:
        t = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        assert t.shape == w.shape and t.tobytes() == w.tobytes(), name
    for name in COUNTS:
        assert getattr(got, name) == int(np.asarray(getattr(want, name)))


def test_write_obj_and_generators_equal_jax(tmp_path):
    from raytracer_tpu.utils import assets as jax_assets

    for sub in (0, 1, 3):
        a = assets.make_icosphere(sub, 2.5)
        assert a.tobytes() == jax_assets.make_icosphere(sub, 2.5).tobytes()
    tris = np.concatenate([assets.make_icosphere(1, 7.0),
                           assets.make_terrain(n=6, extent=3.0)])
    assets.write_obj(str(tmp_path / "port.obj"), tris)
    jax_assets.write_obj(str(tmp_path / "jax.obj"), tris)
    assert (tmp_path / "port.obj").read_bytes() == \
        (tmp_path / "jax.obj").read_bytes()


def test_asset_path_searches_caller_then_env(tmp_path, monkeypatch):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    (tmp_path / "b" / "m.obj").write_text("")
    monkeypatch.setenv("RAYTPU_ASSETS", str(tmp_path / "b"))
    assert assets.asset_path("m.obj") == str(tmp_path / "b" / "m.obj")
    (tmp_path / "a" / "m.obj").write_text("")
    assert assets.asset_path("m.obj", [str(tmp_path / "a")]) == \
        str(tmp_path / "a" / "m.obj")
    monkeypatch.delenv("RAYTPU_ASSETS")
    with pytest.raises(FileNotFoundError):
        assets.asset_path("m.obj")


def test_procedural_obj_is_written_whole_in_its_own_dir(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    tris = assets.make_icosphere(1, 1.0)
    path = presets._procedural_obj("ball.obj", tris)
    assert os.path.dirname(path) == str(tmp_path / "raytpu_torch_assets")
    assert os.listdir(os.path.dirname(path)) == ["ball.obj"]
    assets.write_obj(str(tmp_path / "want.obj"), tris)
    assert open(path, "rb").read() == (tmp_path / "want.obj").read_bytes()
    # A cached file is reused as it is.
    assert presets._procedural_obj("ball.obj", tris[:1]) == path
    assert open(path, "rb").read() == (tmp_path / "want.obj").read_bytes()


@pytest.mark.parametrize("name", list(presets.ALL_PRESETS))
def test_preset_equals_jax(name, tmp_path, monkeypatch):
    from raytracer_tpu.scene import builder as jax_builder
    from raytracer_tpu.scene import presets as jax_presets

    # Both packages cache procedural meshes under the temp dir: a private
    # one here, so no other process writes them meanwhile.
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    ours = presets.ALL_PRESETS[name]()
    theirs = jax_presets.ALL_PRESETS[name]()
    assert ours.name == theirs.name == name
    assert dataclasses.asdict(ours.config) == \
        dataclasses.asdict(theirs.config)
    assert (ours.sky_enabled, ours.exposure) == \
        (theirs.sky_enabled, theirs.exposure)

    mine, ref = ours.scene.get_instances(), theirs.scene.get_instances()
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        a, b = a.to_json(), b.to_json()
        assert os.path.basename(a.pop("model_path")) == \
            os.path.basename(b.pop("model_path"))
        assert a == b
    for a, b in zip(builder.gather_triangles(mine),
                    jax_builder.gather_triangles(ref)):
        assert a.shape[0] > 0 and a.tobytes() == b.tobytes()

    uo = ours.camera.uniforms(ours.sky_enabled, ours.exposure, device="cpu")
    ut = theirs.camera.uniforms(theirs.sky_enabled, theirs.exposure)
    for f in ("origin", "lower_left_corner", "horizontal", "vertical",
              "frame_count", "sky_enabled", "exposure"):
        assert getattr(uo, f).numpy().tobytes() == \
            np.asarray(getattr(ut, f)).tobytes(), f
    assert json.loads(json.dumps([i.to_json() for i in mine]))
