"""The port's render loop (``engine/loop.py``) on the CPU.

Port-only, as the JAX package checks its own (``tests/test_subsystems.py:
82-200``): lifecycle, pipelined frames published in order, a rebuild
that fails keeps the old scene rendering, ladder previews under tick
submissions, event latency tags, and ``stop()`` joining within 5 s. Tiny
frames (32x16 or smaller, 1-2 bounces); every wait has a timeout.
"""

import time

import pytest
import torch

from raytracer_tpu_torch.core.camera import Camera
from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.engine.loop import RenderEngine
from raytracer_tpu_torch.scene.scene import ModelInstance, Scene
from raytracer_tpu_torch.utils import assets

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cube(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("loop") / "cube.obj")
    assets.write_obj(path, assets.make_cube() * 5.0)
    return path


def _cam(aspect):
    return Camera(origin=(0, 2, 20), look_at=(0, 0, 0), vfov_deg=40,
                  aspect_ratio=aspect)


def _frames(engine, cam, n, timeout=30.0, tick=True):
    """Submit uniforms (the counter growing once a frame, as the viewer's
    tick does) until ``n`` frames publish or ``timeout`` passes."""
    out = []
    deadline = time.time() + timeout
    while time.time() < deadline and len(out) < n:
        f = engine.latest_frame()
        if f is not None:
            out.append(f)
            if tick:
                cam.increment_frame_count()
        engine.submit_camera_update(cam.uniforms(device="cpu"))
        time.sleep(0.01)
    return out


def _stop(engine):
    t0 = time.perf_counter()
    engine.stop()
    assert time.perf_counter() - t0 < 5.5
    assert not engine._thread.is_alive()
    assert not engine._publisher.is_alive()


def test_engine_lifecycle(cube):
    cfg = RenderConfig(width=32, height=24, max_bounces=2)
    engine = RenderEngine(cfg, device="cpu")
    engine.start()
    try:
        built = engine.rebuild_scene_async(Scene([ModelInstance(cube)]))
        assert built.result(timeout=30).num_triangles == 12
        assert engine._device_builder.last_mode == "instanced"
        frames = _frames(engine, _cam(32 / 24), 2)
        assert frames, "no frame rendered"
        assert frames[0].pixels.shape == (24, 32, 3)
        assert frames[0].rays_traced > 0 and frames[0].samples >= 1
        assert engine.meter.fps >= 0 and "dispatch" in \
            engine.profiler.summary()
    finally:
        _stop(engine)


def test_pipeline_depth_publishes_in_order(monkeypatch):
    monkeypatch.setenv("RAYTPU_PIPELINE", "3")
    engine = RenderEngine(RenderConfig(width=16, height=16, max_bounces=1),
                          device="cpu")
    engine.start()
    try:
        engine.rebuild_scene_async(Scene([])).result(timeout=30)
        cam = _cam(1.0)
        engine.submit_camera_update(cam.uniforms(device="cpu"))
        numbers = []
        deadline = time.time() + 30
        while time.time() < deadline and len(numbers) < 6:
            f = engine.latest_frame()
            if f is not None:
                numbers.append(f.frame_number)
            time.sleep(0.01)
        assert len(numbers) >= 6, "pipelined loop published no frames"
        assert numbers == sorted(numbers)
    finally:
        _stop(engine)
    tail = engine.latest_frame()  # stop() flushed the in-flight tail
    assert tail is None or tail.frame_number >= numbers[-1]


def test_bad_rebuild_keeps_the_old_scene(cube, monkeypatch):
    engine = RenderEngine(RenderConfig(width=16, height=16, max_bounces=1),
                          device="cpu")
    engine.start()
    try:
        # A missing mesh is skipped (an empty scene, not an error).
        missing = Scene([ModelInstance("/definitely/missing.obj")])
        assert engine.rebuild_scene_async(missing).result(
            timeout=30).num_triangles == 0
        engine.rebuild_scene_async(Scene([ModelInstance(cube)])).result(
            timeout=30)
        cam = _cam(1.0)
        before = _frames(engine, cam, 1)
        # A rebuild that raises (a refused knob) leaves the cube scene.
        monkeypatch.setenv("RAYTPU_DEVICE_BUILD", "bogus")
        fut = engine.rebuild_scene_async(Scene([ModelInstance(cube)]))
        with pytest.raises(NotImplementedError):
            fut.result(timeout=30)
        assert not engine.build_in_progress
        after = _frames(engine, cam, 2)
        assert before and len(after) == 2
        assert after[-1].frame_number > before[-1].frame_number
        assert after[-1].pixels.any()
    finally:
        _stop(engine)


def test_ladder_ticks_do_not_starve_full_frames(monkeypatch):
    """Tick submissions with a growing counter must not drop frames: the
    ladder serves previews, then full-resolution frames, then previews
    again after a reset."""
    monkeypatch.setenv("RAYTPU_LADDER_SCALE", "2")
    engine = RenderEngine(RenderConfig(width=32, height=16, max_bounces=1),
                          ladder_frames=2, device="cpu")
    assert engine._preview is not None
    engine.start()
    try:
        engine.rebuild_scene_async(Scene([])).result(timeout=30)
        cam = _cam(2.0)
        kinds = []
        deadline = time.time() + 30
        while time.time() < deadline and kinds.count(False) < 3:
            f = engine.latest_frame()
            if f is not None:
                kinds.append(f.preview)
                assert f.pixels.shape == (16, 32, 3)
                cam.increment_frame_count()
            engine.submit_camera_update(cam.uniforms(device="cpu"))
            time.sleep(0.005)
        assert kinds.count(True) >= 1, "ladder previews never published"
        assert kinds.count(False) >= 3, f"full frames starved: {kinds}"
        cam.reset_accumulation()
        engine.submit_camera_update(cam.uniforms(device="cpu"))
        deadline = time.time() + 30
        again = False
        while time.time() < deadline and not again:
            f = engine.latest_frame()
            again = f is not None and f.preview
            time.sleep(0.005)
        assert again
    finally:
        _stop(engine)


def test_ladder_knob_applies_only_without_an_argument(monkeypatch):
    monkeypatch.setenv("RAYTPU_LADDER", "4")
    cfg = RenderConfig(width=32, height=16, max_bounces=1)
    assert RenderEngine(cfg, device="cpu")._ladder_frames == 4
    assert RenderEngine(cfg, ladder_frames=0,
                        device="cpu")._preview is None


def test_event_latency_tags_the_first_frame(cube):
    engine = RenderEngine(RenderConfig(width=16, height=16, max_bounces=1),
                          device="cpu")
    engine.start()
    try:
        engine.rebuild_scene_async(Scene([ModelInstance(cube)])).result(
            timeout=30)
        cam = _cam(1.0)
        assert _frames(engine, cam, 1)
        uni = cam.uniforms(device="cpu")
        uni.event_t = time.perf_counter()
        engine.submit_camera_update(uni)
        deadline = time.time() + 30
        while time.time() < deadline and engine.last_event_frame is None:
            time.sleep(0.005)
        tagged = engine.last_event_frame
        assert tagged is not None and tagged.wait_ms is not None
        assert tagged.input_latency_ms == pytest.approx(
            tagged.wait_ms + tagged.render_ms, abs=1.0)
        assert engine.last_input_latency_ms == tagged.input_latency_ms
    finally:
        _stop(engine)


def test_cuda_engine_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RenderEngine(RenderConfig(width=16, height=16))
