"""The bounce engine's fixed-width steps over static buffers
(``kernels/wavefront.py``, ``kernels/stepgraphs.py``) on the CPU.

A CUDA graph cannot be captured here, so ``_Recorded`` stands in for the
card's workspace: its capture records the step's function and its replay
calls it, over the same static buffers, shared by the bands and kept
from frame to frame, that the card's graphs write.

* ``test_recorded_frame_matches_jax``: the 128x64 frames of
  ``tests/test_torch_schedule.py`` (two bands and the tail merge, with
  round caps 2 and 3 and unordered walks; and under
  ``RAYTPU_TAIL_MERGE=0``), and the ``fused`` / ``fused_packed`` frames
  of ``tests/test_torch_paths.py``, rendered twice: the second render
  replays its steps, and both match the stored JAX reference as those
  tests hold the eager frame to it.
* ``test_recorded_frames_equal_eager``: three frames through the
  workspace against three eager ones (each a fresh scene object, which
  stays eager), byte for byte, on the default path and under
  ``RAYTPU_WAVE=fused|fused_packed``, ``RAYTPU_SORT_KEY=pos`` (the key
  computed on the host), ``RAYTPU_DEPOSIT=rows|ch`` and
  ``RAYTPU_TAIL_MERGE=0``.
* the live count carried across a shrink against a recount; the split
  engine's rounds on state sorted by its key; the graveyard written at
  static offsets against the list-and-cat one; the step keys against
  every host value a graph bakes in; the rule that engages a workspace.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from test_torch_paths import CAM, PATHS
from test_torch_paths import CFG as PATHS_CFG
from test_torch_paths import path_refs  # noqa: F401 (a fixture)
from test_torch_renderer import _bounce0_tie_pixels, _sub, _two_cubes
from test_torch_schedule import CFG, FRAMES
from test_torch_schedule import refs  # noqa: F401 (a fixture)

from raytracer_tpu_torch.core.camera import Camera
from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.engine.renderer import Renderer
from raytracer_tpu_torch.kernels import launches, stepgraphs, wavefront
from raytracer_tpu_torch.scene.builder import (build_fast_scene_from_arrays,
                                               camera_uniforms_from_numpy,
                                               fast_scene_from_numpy)

torch.set_num_threads(2)


class _Recorded(stepgraphs.Workspace):
    """The card's workspace with a recorded function for a graph."""

    def _record(self, fn):
        return fn

    def _replay(self, graph) -> None:
        graph()

    def _reserved(self) -> int:
        return 0


@pytest.fixture
def recorded(monkeypatch):
    """Workspaces on the CPU: the scene counts as on the card, the kernel
    wrappers still run their plain versions."""
    monkeypatch.setattr(stepgraphs, "_card", lambda device: True)
    monkeypatch.setattr(stepgraphs, "Workspace", _Recorded)
    monkeypatch.setattr(wavefront, "MIN_WIDTH", 2048)
    stepgraphs.reset()
    launches.reset()
    yield
    stepgraphs.reset()


def _events(kind: str = "") -> dict:
    return {k: v for k, v in launches.graphs.items() if k.startswith(kind)}


def _check_against(ref, scene, uni, cfg, accum, image, stats):
    np.testing.assert_allclose(accum.numpy(), ref["accum_0"], rtol=0,
                               atol=2e-5)
    differ = (image.numpy() != ref["image_0"]).any(-1)
    ties = _bounce0_tie_pixels(scene, cfg, uni)
    assert not (differ & ~ties).any(), np.argwhere(differ & ~ties)[:10]
    assert int(stats["rays_traced"]) == int(ref["rays_0"])


JAX_FRAMES = ["unordered_bcaps", "no_merge", "fused", "fused_packed"]


@pytest.mark.parametrize("name", JAX_FRAMES)
def test_recorded_frame_matches_jax(recorded, refs, path_refs,  # noqa: F811
                                    monkeypatch, name):
    if name in FRAMES:
        env, ref, cfg = FRAMES[name][0], refs["frames"][name], CFG
    else:
        env, ref, cfg = PATHS[name][0], path_refs[name], PATHS_CFG
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = RenderConfig(**cfg)
    scene = fast_scene_from_numpy(_sub(ref, "scene_"), device="cpu")
    uni = camera_uniforms_from_numpy(_sub(ref, "cam0_"), device="cpu")
    first = Renderer(cfg).render(scene, uni)
    assert _events() and not _events("capture") and not _events("replay")
    launches.reset()
    second = Renderer(cfg).render(scene, uni)
    assert _events("replay.round") and not _events("eager")
    assert _events("capture.round")
    for accum, image, stats in (first, second):
        _check_against(ref, scene, uni, cfg, accum, image, stats)
    assert second[0].numpy().tobytes() == first[0].numpy().tobytes()


def _camera():
    return Camera(origin=CAM["cam_origin"], look_at=CAM["cam_look"],
                  vfov_deg=CAM["cam_vfov"], aspect_ratio=2.0)


def _frames(scene_of, cfg, n=3):
    """n progressive frames, the scene of frame f ``scene_of(f)`` ->
    [(accum bytes, image, rays)]."""
    cam, acc, out = _camera(), None, []
    for fc in range(n):
        cam.frame_count = fc
        acc, img, st = Renderer(cfg).render(scene_of(fc),
                                            cam.uniforms(device="cpu"), acc)
        out.append((acc.numpy().tobytes(), img.numpy().tobytes(),
                    int(st["rays_traced"])))
    return out


@pytest.fixture(scope="module")
def cubes():
    verts, mats = _two_cubes()
    return build_fast_scene_from_arrays(verts, mats, device="cpu")


KNOB_PATHS = {
    "default": {},
    "fused": {"RAYTPU_WAVE": "fused"},
    "fused_packed": {"RAYTPU_WAVE": "fused_packed"},
    "sort_key_pos": {"RAYTPU_SORT_KEY": "pos"},
    "deposit_rows": {"RAYTPU_DEPOSIT": "rows"},
    "deposit_ch": {"RAYTPU_DEPOSIT": "ch"},
    "tail_merge_0": {"RAYTPU_TAIL_MERGE": "0"},
}


@pytest.mark.parametrize("path", list(KNOB_PATHS))
def test_recorded_frames_equal_eager(recorded, cubes, monkeypatch, path):
    for k, v in KNOB_PATHS[path].items():
        monkeypatch.setenv(k, v)
    cfg = RenderConfig(**CFG)
    eager = _frames(lambda f: dataclasses.replace(cubes), cfg)
    assert not _events("capture") and not _events("replay")
    launches.reset()
    scene = dataclasses.replace(cubes)
    got = _frames(lambda f: scene, cfg)
    assert _events("capture") and _events("replay.round")
    for f, (g, e) in enumerate(zip(got, eager)):
        assert g == e, f"frame {f} differs"


def test_carried_live_count_equals_a_recount(recorded, cubes, monkeypatch):
    """Every shrink's carried count against the live rays it kept, eager
    and recorded, and where the band leaves a level out of bounces."""
    shrink, seen = wavefront._Ladder.shrink, []

    def checked(lad, w, w2, live):
        got = shrink(lad, w, w2, live)
        assert got == int(wavefront._alive(lad.X[w2]).sum())
        seen.append((lad.space.static, got))
        return got

    monkeypatch.setattr(wavefront._Ladder, "shrink", checked)
    for bounces in (4, 2):
        monkeypatch.setenv("RAYTPU_TAIL_MERGE", "1" if bounces > 2 else "0")
        cfg = RenderConfig(**dict(CFG, max_bounces=bounces))
        scene = dataclasses.replace(cubes)
        _frames(lambda f: scene, cfg, n=2)
    assert {s for s, _ in seen} == {False, True}
    assert any(live > 0 for _, live in seen)


def test_split_rounds_run_on_sorted_state(cubes, monkeypatch):
    """``RAYTPU_WAVE=split`` (eager) sorts each round by its key before
    the round, as the JAX wavefront does: every state a split round gets
    is in key order, where the level's state before the sort is not."""
    split_round, got, before = wavefront._Ladder._split_round, [], []

    def checked(lad, state):
        def ordered(x):
            k = wavefront._state_key(x, lad.scene, "split", lad.mode)
            return bool((k[1:] >= k[:-1]).all())

        got.append(ordered(state))
        before.append(ordered(lad.X[state.shape[1]]))
        return split_round(lad, state)

    monkeypatch.setattr(wavefront._Ladder, "_split_round", checked)
    monkeypatch.setattr(wavefront, "MIN_WIDTH", 2048)
    monkeypatch.setenv("RAYTPU_WAVE", "split")
    _render(cubes)
    assert got and all(got), got
    assert not all(before), before


def _grave_by_list(n, parts):
    """The graveyard as it was: a list of (pix, colour bits) blocks, one
    cat, one stable sort."""
    g = torch.cat([torch.stack([p, *d.view(torch.int32)], dim=1)
                   for p, d in parts])
    g = g.index_select(0, torch.argsort(g[:, 0], stable=True))
    return g[:n, 1:4].T.contiguous().view(torch.float32)


def test_graveyard_at_static_offsets_equals_list_and_cat():
    r = np.random.default_rng(3)
    p, widths = 8192, [8192, 4096, 2048]
    pix = torch.from_numpy(r.permutation(p).astype(np.int32))
    pix[-100:] = p + 7                    # pads: past every real pixel
    dep = torch.from_numpy(r.standard_normal((3, p)).astype(np.float32))
    dep[:, ::17] = -0.0
    # The blocks a band deposits: each shrink's tail, then the last level.
    spans = [(p - w, p - w2) for w, w2 in zip(widths, widths[1:])]
    spans.append((p - widths[-1], p))
    parts = [(pix[a:b], dep[:, a:b]) for a, b in spans]
    deposits = wavefront._Deposits(p, "cpu", "grave")
    for (a, _), (pp, dd) in zip(spans, parts):
        deposits.add(pp, dd, at=a)
    got = deposits.colors(out=torch.empty((3, p)))
    want = _grave_by_list(p, parts)
    assert got.view(torch.int32).numpy().tobytes() == \
        want.view(torch.int32).numpy().tobytes()


def _ladder_key(scene, cfg, **over):
    args = dict(engine="fused12", mode="cid", widths=[4096, 2048],
                caps=(1,), deposit_mode="grave", n=4096, role="band",
                glue="one", gather="col", rows=13, handoff=True, sky_on=True)
    args.update(over)
    sky_on = args.pop("sky_on")
    lad = wavefront._Ladder(scene, sky_on, cfg, **args)
    return lad.key, [k for k, _, _ in lad.steps()]


def test_step_keys_change_with_every_baked_host_value(cubes, monkeypatch):
    cfg = RenderConfig(**CFG)
    base, steps = _ladder_key(cubes, cfg)
    assert len(set(steps)) == len(steps) == 3     # round, shrink, handoff
    variants = {
        "width": dict(widths=[4096, 1024]),
        "cap": dict(caps=(1, 2)),
        "engine": dict(engine="fused", rows=16),
        "mode": dict(mode="pd5"),
        "glue": dict(glue="perfield"),
        "gather": dict(gather="row"),
        "deposit": dict(deposit_mode="rows"),
        "sky_on": dict(sky_on=False),
        "role": dict(role="tail", handoff=False),
    }
    for f in ("fuzz", "t_min", "t_max", "det_eps"):
        variants[f] = dict(cfg=dataclasses.replace(
            cfg, **{f: getattr(cfg, f) * 0.5}))
    variants["emissive_emits"] = dict(cfg=dataclasses.replace(
        cfg, emissive_emits=not cfg.emissive_emits))
    monkeypatch.setenv("RAYTPU_CLUSTER", "4")
    verts, mats = _two_cubes()
    layout = build_fast_scene_from_arrays(verts, mats, device="cpu")
    variants["layout"] = dict(scene=layout)
    monkeypatch.delenv("RAYTPU_CLUSTER")
    keys = {}
    for name, over in variants.items():
        scene = over.pop("scene", cubes)
        keys[name] = _ladder_key(scene, over.pop("cfg", cfg), **over)
    monkeypatch.setenv("RAYTPU_ORDER_MINW", str(1 << 30))
    keys["ordered"] = _ladder_key(cubes, cfg)
    assert layout.layout != cubes.layout
    for name, (key, _) in keys.items():
        assert key != base, name
    # Each step's key: its ladder's, its kind and its own values.
    assert all(s[:len(base)] == base for s in steps)
    assert [s[len(base):] for s in steps] == [
        ("round", 4096, 1), ("shrink", 4096, 2048), ("handoff", 2048)]
    assert {s[len(base):] for s in keys["cap"][1]} >= {
        ("round", 4096, 1), ("round", 4096, 2)}
    # The scene is keyed by the workspace that holds the graphs: another
    # scene object, with the same tables, gets a workspace of its own.
    monkeypatch.delenv("RAYTPU_ORDER_MINW")
    monkeypatch.setattr(stepgraphs, "_card", lambda device: True)
    stepgraphs.reset()
    try:
        a, b = dataclasses.replace(cubes), dataclasses.replace(cubes)
        assert _ladder_key(a, cfg)[0] == _ladder_key(b, cfg)[0] == base
        stepgraphs.begin_render(a)
        ws = stepgraphs.workspace(a)
        stepgraphs.begin_render(b)
        assert ws is not None and stepgraphs.workspace(a) is None
        assert stepgraphs.workspace(b) not in (None, ws)
    finally:
        stepgraphs.reset()


def _render(scene, cfg=None):
    cfg = cfg or RenderConfig(**CFG)
    cam = _camera()
    launches.reset()
    Renderer(cfg).render(scene, cam.uniforms(device="cpu"))
    return _events()


def test_engagement_rule(recorded, cubes, monkeypatch):
    a = dataclasses.replace(cubes)
    assert not _events("replay") and _render(a) and not _events("replay")
    ws = stepgraphs._spaces[torch.device("cpu")]
    assert ws.scene is a and ws.renders == 1
    _render(a)
    assert _events("capture") and _events("replay") and not _events("eager")
    assert ws.graphs and ws.buffer_bytes() > 0
    _render(a)
    assert not _events("capture") and _events("replay")
    # A new scene replaces the workspace and renders eagerly first.
    b = dataclasses.replace(cubes)
    _render(b)
    assert not _events("replay") and _events("eager")
    assert stepgraphs._spaces[torch.device("cpu")].scene is b
    _render(b)
    assert _events("replay")
    # Under plain_versions(), or from another thread: eager.
    with launches.plain_versions("raygen"):
        assert not _render(b).get("replay.round")
    box = []
    t = threading.Thread(target=lambda: box.append(_render(b)))
    t.start()
    t.join()
    assert box and not any(k.startswith("replay") for k in box[0])
    assert _render(b).get("replay.round")
    # The split engine stays eager.
    monkeypatch.setenv("RAYTPU_WAVE", "split")
    for _ in range(2):
        ev = _render(b)
    assert ev.get("eager.round") and not _events("replay")


def test_cpu_renders_stay_eager(cubes, monkeypatch):
    monkeypatch.setattr(wavefront, "MIN_WIDTH", 2048)
    stepgraphs.reset()
    for _ in range(2):
        ev = _render(cubes)
    assert ev.get("eager.round") and not _events("replay")
    assert not stepgraphs._spaces


def test_threads_take_only_their_own_workspace(recorded):
    """Threads rendering scenes of their own on one device, more threads
    than cores, the switch interval shortened: a thread is handed only a
    workspace of its own scene that it owns, and only its own renders
    count."""
    import os
    import sys
    import types

    n = 2 * (os.cpu_count() or 4)
    errors = []

    def work():
        scene = types.SimpleNamespace(device="cpu")
        me = threading.get_ident()
        try:
            for _ in range(300):
                stepgraphs.begin_render(scene)
                ws = stepgraphs.workspace(scene)
                if ws is not None and (ws.scene is not scene
                                       or ws.thread != me):
                    errors.append("foreign workspace")
                if ws is not None and ws.renders < 1:
                    errors.append("render not counted")
        except Exception as e:  # noqa: BLE001 (reported by the assert)
            errors.append(repr(e))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:5]
