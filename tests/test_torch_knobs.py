"""Every result-bearing knob of the JAX package runs its JAX A/B value
in the port (``PORTED``: the XLA path's and host builds' knobs, the
sorted rounds' A/B knobs and the table layout): the port refuses no
knob off its default.

Each knob is exercised through the entry point that reads it: a tiny
frame (16x8, three bounces, one band: bounce 0, the sorted rounds, the
tail-merge decision), the same frame on the ``fused_packed`` engine or
the pmega path, a scene build, or an .obj load; the layout knobs also
through the device builders, as the JAX package takes them."""

import numpy as np
import pytest
import torch

from raytracer_tpu_torch import knobs
from raytracer_tpu_torch.core.camera import Camera
from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.engine.renderer import Renderer
from raytracer_tpu_torch.kernels import launches, wavefront
from raytracer_tpu_torch.scene.builder import build_fast_scene_from_arrays
from raytracer_tpu_torch.scene.device_builder import DeviceSceneBuilder
from raytracer_tpu_torch.scene.objloader import load_obj
from raytracer_tpu_torch.scene.scene import ModelInstance
from raytracer_tpu_torch.utils import assets

torch.set_num_threads(2)


def _arrays():
    cube = assets.make_cube() * 4.0 + np.array([0, -6, 0], np.float32)
    plane = (assets.make_ground_plane() * np.array([150, 1, 150], np.float32)
             + np.array([0, -10, 0], np.float32))
    verts = np.concatenate([plane, cube]).astype(np.float32)
    mats = np.full((verts.shape[0], 4), 0.6, np.float32)
    mats[:, 3] = 0.0
    return verts, mats


@pytest.fixture(scope="module")
def scene():
    return build_fast_scene_from_arrays(*_arrays(), device="cpu")


def _frame(scene, env=None):
    def run(mp):
        for k, v in (env or {}).items():
            mp.setenv(k, v)
        cfg = RenderConfig(width=16, height=8, max_bounces=3)
        uni = Camera((-10.0, 6.0, 30.0), (0.0, -6.0, 0.0), vfov_deg=40.0,
                     aspect_ratio=2.0).uniforms(device="cpu")
        accum, _, _ = Renderer(cfg).render(scene, uni)
        assert accum.max() > 0
    return run


def _load(tmp_path):
    path = tmp_path / "cube.obj"
    assets.write_obj(str(path), assets.make_cube())

    def run(mp):
        assert load_obj(str(path)).shape == (12, 3, 3)
    return run


# The knobs the port once refused off their default, each with the value
# the JAX package's A/B path takes (``test_ported_knob_runs_its_jax_value``).
PORTED = {"RAYTPU_COMPACT_FLOOR": "512", "RAYTPU_COMPACT_RATIO": "4",
          "RAYTPU_BVH": "median", "RAYTPU_NATIVE": "0",
          "RAYTPU_LEAF_COUNTS": "0",
          # The table layout: the scene keeps the layout it was built in.
          "RAYTPU_CLUSTER": "4", "RAYTPU_WIDE": "16",
          # The sorted rounds' knobs (the frame's kernels walk and shade
          # every ray as before, so the frame keeps its bytes).
          "RAYTPU_TAIL_MERGE": "0", "RAYTPU_SORT_KEY": "om9",
          "RAYTPU_GLUE": "perfield", "RAYTPU_DEPOSIT": "rows",
          "RAYTPU_PACK_GATHER": "row", "RAYTPU_WAVE_MINW": "2048",
          "RAYTPU_WAVE_BCAP": "2", "RAYTPU_TAIL_BCAP": "3",
          "RAYTPU_ORDER_MINW": "65536", "RAYTPU_DEEP_SUB": "32",
          "RAYTPU_DEEP_MAXW": "100000"}
# The engine a ported round knob needs (perfield: the JAX package runs it
# on the colour-carrying rounds only), and the plain version of kernel B
# the frame runs under it.
ROUND_KNOBS = {
    "RAYTPU_TAIL_MERGE": ({}, "bounce12"),
    "RAYTPU_SORT_KEY": ({}, "bounce12_om9"),
    "RAYTPU_GLUE": ({"RAYTPU_WAVE": "fused"}, "bounce15"),
    "RAYTPU_DEPOSIT": ({}, "bounce12"),
    "RAYTPU_PACK_GATHER": ({"RAYTPU_WAVE": "fused_packed"}, "bounce_packed"),
    "RAYTPU_WAVE_MINW": ({}, "bounce12"),
    "RAYTPU_WAVE_BCAP": ({}, "bounce12"),
    "RAYTPU_TAIL_BCAP": ({}, "bounce12"),
    "RAYTPU_ORDER_MINW": ({}, "bounce12_unordered"),
    "RAYTPU_DEEP_SUB": ({}, "bounce12"),
    "RAYTPU_DEEP_MAXW": ({}, "bounce12"),
}


def test_every_fixed_knob_has_a_case():
    """No knob is refused: the layout knobs, the last two the port took
    in, run their JAX values (``PORTED``)."""
    assert {"RAYTPU_CLUSTER", "RAYTPU_WIDE"} <= set(PORTED)


def _accum(scene, env):
    """The 16x8 frame's accumulator under the knobs ``env``."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        cfg = RenderConfig(width=16, height=8, max_bounces=3)
        uni = Camera((-10.0, 6.0, 30.0), (0.0, -6.0, 0.0), vfov_deg=40.0,
                     aspect_ratio=2.0).uniforms(device="cpu")
        launches.reset()
        accum, _, _ = Renderer(cfg).render(scene, uni)
    return accum.numpy(), cfg, uni


@pytest.mark.parametrize("knob", list(PORTED))
def test_ported_knob_runs_its_jax_value(knob, scene, tmp_path,
                                        monkeypatch):
    """Each ported knob at its JAX A/B value runs and keeps the result:
    the compaction knobs on the ``RAYTPU_BOUNCE=mega`` frame (another
    level schedule, the same bytes), the host-build knobs on a scene built
    under them (another tree renders the default frame except on bounce-0
    tie pixels; full leaf counts the same bytes; a scene built in another
    layout keeps it, renders with the knob unset and walks the same
    binary tree at width 16), the sorted rounds' knobs on the frame
    through the build they select (the same bytes).
    ``RAYTPU_NATIVE=0`` also parses an .obj in Python, as the native
    parser does."""
    from test_torch_renderer import _bounce0_tie_pixels

    value = PORTED[knob]
    if knob in ROUND_KNOBS:
        engine, kernel = ROUND_KNOBS[knob]
        want = _accum(scene, engine)[0]
        got = _accum(scene, dict(engine, **{knob: value}))[0]
        assert launches.plain[kernel] > 0
        assert got.tobytes() == want.tobytes()
        return
    if knob.startswith("RAYTPU_COMPACT_"):
        want = _accum(scene, {"RAYTPU_BOUNCE": "mega"})[0]
        got = _accum(scene, {"RAYTPU_BOUNCE": "mega", knob: value})[0]
        assert got.tobytes() == want.tobytes()
        return
    monkeypatch.setenv(knob, value)
    built = build_fast_scene_from_arrays(*_arrays(), device="cpu")
    monkeypatch.delenv(knob)
    got, cfg, uni = _accum(built, {})
    got_plain = dict(launches.plain)
    want = _accum(scene, {})[0]
    if knob == "RAYTPU_LEAF_COUNTS":
        assert not torch.equal(built.nodes4, scene.nodes4)
        assert got.tobytes() == want.tobytes()
    elif knob in ("RAYTPU_CLUSTER", "RAYTPU_WIDE"):
        layout = {"RAYTPU_CLUSTER": (4, 8), "RAYTPU_WIDE": (8, 16)}[knob]
        assert built.layout == layout != scene.layout
        tag = "c4" if layout[0] == 4 else "w16"
        assert got_plain[f"trace4_{tag}"] and got_plain[f"bounce12_{tag}"]
        if knob == "RAYTPU_WIDE":
            # The same binary tree; its one wide node is 16 slots wide
            # (the 3 leaves in its first row).
            assert torch.equal(built.nodes8.view(torch.int32),
                               scene.nodes8.view(torch.int32))
            assert built.node_rows.shape[1] == 256
        else:
            assert not torch.equal(built.nodes8, scene.nodes8)
        ties = _bounce0_tie_pixels(scene, cfg, uni)
        differ = (got != want).any(-1)
        assert not (differ & ~ties).any()
    else:
        assert not torch.equal(built.nodes8, scene.nodes8)
        ties = _bounce0_tie_pixels(scene, cfg, uni)
        differ = (got != want).any(-1)
        assert not (differ & ~ties).any()
    if knob == "RAYTPU_NATIVE":
        run = _load(tmp_path)
        native = load_obj(str(tmp_path / "cube.obj"))
        monkeypatch.setenv(knob, value)
        run(monkeypatch)
        np.testing.assert_array_equal(
            load_obj(str(tmp_path / "cube.obj")), native)


def test_sort_key_is_read_on_the_pmega_path(scene, monkeypatch):
    """The pmega path sorts once by the host key of ``RAYTPU_SORT_KEY``
    (JAX ``packet.py:686-700``), and its frame keeps its bytes."""
    modes = []
    real = wavefront.sort_key

    def spy(*args, **kw):
        modes.append(args[5] if len(args) > 5 else kw.get("mode"))
        return real(*args, **kw)

    want = _accum(scene, {"RAYTPU_BOUNCE": "pmega"})[0]
    monkeypatch.setattr(wavefront, "sort_key", spy)
    got = _accum(scene, {"RAYTPU_BOUNCE": "pmega",
                         "RAYTPU_SORT_KEY": "pd5"})[0]
    assert modes == ["pd5"] and launches.plain["bounce15"] == 1
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("glue", ["perfield", "packT"])
def test_glue_without_the_colour_rows_raises(scene, monkeypatch, glue):
    """``RAYTPU_GLUE=perfield|packT`` under the default ``fused12`` rounds:
    the JAX package fails there with a ``TypeError`` (its glue iterates the
    colour that the no-colour carry drops); the port names the knob."""
    monkeypatch.setenv("RAYTPU_GLUE", glue)
    with pytest.raises(NotImplementedError, match="RAYTPU_GLUE"):
        _frame(scene)(monkeypatch)
    monkeypatch.setenv("RAYTPU_WAVE", "fused")
    _frame(scene)(monkeypatch)


def test_unknown_sort_key_keys_as_oct_morton(scene):
    """An unknown ``RAYTPU_SORT_KEY`` runs, as in the JAX package: the host
    keys the rounds in the ``oct_morton`` form (``wavefront.py:280``)
    after each round, with the default build of kernel B."""
    want = _accum(scene, {})[0]
    got = _accum(scene, {"RAYTPU_SORT_KEY": "hilbert"})[0]
    assert launches.plain["bounce12"] > 0
    assert got.tobytes() == want.tobytes()
    g = torch.Generator().manual_seed(0)
    o = tuple(torch.rand(64, generator=g) * 40 - 20 for _ in range(3))
    d = tuple(torch.randn(64, generator=g) for _ in range(3))
    alive = torch.rand(64, generator=g) < 0.5
    smin, smax = scene.bounds()
    assert torch.equal(
        wavefront.sort_key(o, d, alive, smin, smax, "hilbert"),
        wavefront.sort_key(o, d, alive, smin, smax, "oct_morton"))


@pytest.mark.parametrize("knob", ["RAYTPU_PALLAS_SUBLANES",
                                  "RAYTPU_PALLAS_BSUBLANES",
                                  "RAYTPU_PALLAS_UNROLL",
                                  "RAYTPU_TRAVERSE_UNROLL"])
def test_tile_shape_knobs_do_not_apply(knob, scene, monkeypatch):
    """The TPU tile shapes change no result and the port does not read
    them: the frame renders as with the knob unset."""
    monkeypatch.setenv(knob, "7")
    _frame(scene)(monkeypatch)
    assert knob in knobs.__doc__


def _two_cubes(tmp_path):
    path = str(tmp_path / "cube.obj")
    assets.write_obj(path, assets.make_cube())
    return [ModelInstance(path, "a", position=(0, -2, 0), scale=(4, 4, 4)),
            ModelInstance(path, "b", position=(6, 0, 2), scale=(2, 2, 2))]


@pytest.mark.parametrize("knob,value", [("RAYTPU_CLUSTER", "4"),
                                        ("RAYTPU_WIDE", "16")])
def test_device_ploc_refuses_other_layouts(knob, value, tmp_path,
                                           monkeypatch):
    """The device PLOC tree builds the default layout only (the JAX build
    asserts it): under another it raises, naming the knob, through the
    device builder's fallbacks."""
    monkeypatch.setenv("RAYTPU_DEVICE_BUILD", "lbvh")
    monkeypatch.setenv("RAYTPU_DEVICE_TREE", "ploc")
    monkeypatch.setenv(knob, value)
    with pytest.raises(NotImplementedError, match=knob):
        DeviceSceneBuilder("cpu").build(_two_cubes(tmp_path))


def test_wide16_refit_falls_back_to_the_lbvh(tmp_path, monkeypatch):
    """At ``RAYTPU_WIDE=16`` the refit capture refuses (8-wide only), so
    ``DeviceSceneBuilder`` in ``refit`` mode builds the LBVH, which has no
    wide table at that width, as the JAX package ends; ``instanced``
    builds its 16-wide TLAS."""
    monkeypatch.setenv("RAYTPU_WIDE", "16")
    monkeypatch.setenv("RAYTPU_DEVICE_BUILD", "refit")
    b = DeviceSceneBuilder("cpu")
    scene = b.build(_two_cubes(tmp_path))
    assert b.last_mode == "lbvh" and scene.nodes4 is None
    assert scene.layout == (8, 16) and scene.num_nodes4 is None
    monkeypatch.setenv("RAYTPU_DEVICE_BUILD", "instanced")
    scene = b.build(_two_cubes(tmp_path))
    assert b.last_mode == "instanced" and scene.layout == (8, 16)
    assert scene.nodes4.shape[0] == 2 * 64  # bucket(1 + 2 BLAS nodes)
