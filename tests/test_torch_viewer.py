"""The port's viewer (``apps/viewer.py``): every HTTP route over a live
``ViewerApp`` on the CPU.

Port-only, mirroring the JAX package's ``tests/test_viewer.py`` on a
32x16 frame with 2 bounces (the resolution ladder applies: 32 and 16 are
multiples of 16). Every edit lands as a device rebuild through the
engine's ``DeviceSceneBuilder``; every wait has a timeout of 30 s or
less.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import pytest
import torch

from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.scene.scene import ModelInstance, Scene
from raytracer_tpu_torch.utils import assets

torch.set_num_threads(2)

W, H = 32, 16


@pytest.fixture(scope="module")
def viewer(tmp_path_factory):
    from raytracer_tpu_torch.apps.viewer import ViewerApp, make_handler

    tmp = tmp_path_factory.mktemp("viewer")
    cube_path = str(tmp / "cube.obj")
    assets.write_obj(cube_path, assets.make_cube() * 4.0)
    scene = Scene([ModelInstance(model_path=cube_path, display_name="cube_a",
                                 position=(0.0, -6.0, 0.0))])
    app = ViewerApp(RenderConfig(width=W, height=H, max_bounces=2), scene,
                    device="cpu")
    app.start()
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(app))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    yield app, base, str(tmp), cube_path
    server.shutdown()
    server.server_close()
    app.stop()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return r.status, r.read()


def _post(base, path, data):
    req = urllib.request.Request(
        base + path, data=json.dumps(data).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


def _state(base):
    return json.loads(_get(base, "/api/state")[1])


def _wait(pred, timeout=30.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


def _rebuilt(app, n):
    """True once the engine's builder has finished n builds."""
    return _wait(lambda: app.engine.profiler.summary().get(
        "build", {}).get("count", 0) >= n and not app.engine.build_in_progress)


def test_index_and_state(viewer):
    app, base, _, _ = viewer
    status, body = _get(base, "/")
    assert status == 200 and b"raytracer_tpu_torch viewer" in body
    s = _state(base)
    assert [i["display_name"] for i in s["instances"]] == ["cube_a"]
    assert s["camera"]["origin"] == [-25.0, 30.0, 140.0]


def test_frame_renders_and_stats_flow(viewer):
    app, base, _, _ = viewer
    assert _wait(lambda: _state(base)["stats"] is not None), \
        "no frame rendered within timeout"
    status, body = _get(base, "/frame.jpg")
    assert status == 200 and len(body) > 100
    s = _state(base)
    assert s["stats"]["samples"] >= 1
    assert "dispatch" in s["stages"] and "readback" in s["stages"]
    assert s["stages"]["build"]["count"] >= 1
    assert app.engine._device_builder.last_mode == "instanced"


def test_key_moves_camera_and_resets_accumulation(viewer):
    app, base, _, _ = viewer
    z0 = _state(base)["camera"]["origin"][2]
    _post(base, "/api/key", {"key": "W"})  # -6.5 z (VulkanApp.java:756)
    s = _state(base)
    assert s["camera"]["origin"][2] == pytest.approx(z0 - 6.5)
    assert s["camera"]["frame_count"] <= 3


def test_settings_routes(viewer):
    app, base, _, _ = viewer
    _post(base, "/api/settings", {"sky": False, "exposure": 1.5})
    s = _state(base)
    assert s["sky_enabled"] is False and s["exposure"] == 1.5
    _post(base, "/api/settings", {"sky": True, "exposure": 99.0})
    assert _state(base)["exposure"] == 5.0  # the reference slider's range


def test_add_update_remove_rebuild_on_the_device(viewer):
    app, base, _, cube_path = viewer
    n = app.engine.profiler.summary()["build"]["count"]
    _post(base, "/api/instance/add",
          {"model_path": cube_path, "display_name": "cube_b",
           "position": [8, -6, 0]})
    assert _rebuilt(app, n + 1)
    _post(base, "/api/instance/add",
          {"model_path": cube_path, "display_name": "cube_c",
           "position": [-8, -6, 0]})
    assert _rebuilt(app, n + 2)
    names = [i["display_name"] for i in _state(base)["instances"]]
    assert names == ["cube_a", "cube_b", "cube_c"]

    # Updating the middle instance keeps the order.
    _post(base, "/api/instance/1/update",
          {"position": [9, -5, 1], "material_type": 1.0})
    assert _rebuilt(app, n + 3)
    s = _state(base)
    assert [i["display_name"] for i in s["instances"]] == \
        ["cube_a", "cube_b", "cube_c"]
    assert s["instances"][1]["position"] == [9, -5, 1]
    assert s["instances"][1]["material_type"] == 1.0

    _post(base, "/api/instance/1/remove", {})
    assert _rebuilt(app, n + 4)
    names = [i["display_name"] for i in _state(base)["instances"]]
    assert names == ["cube_a", "cube_c"]
    assert app.engine._device_builder.last_mode == "instanced"


def test_scene_save_load_roundtrip(viewer):
    app, base, tmp, _ = viewer
    path = tmp + "/saved.json"
    _post(base, "/api/scene/save", {"path": path})
    before = [i["display_name"] for i in _state(base)["instances"]]
    _post(base, "/api/instance/0/remove", {})
    assert len(_state(base)["instances"]) == len(before) - 1
    _wait(lambda: not app.engine.build_in_progress)
    _post(base, "/api/scene/load", {"path": path})
    assert [i["display_name"] for i in _state(base)["instances"]] == before


def test_resolution_ladder_preview_then_full(viewer):
    app, base, _, _ = viewer
    assert app.engine._preview is not None
    assert _wait(lambda: _state(base)["stats"] is not None)
    _post(base, "/api/key", {"key": "Q"})  # reset accumulation
    assert _wait(lambda: (_state(base)["stats"] or {}).get("preview")
                 is True), "no preview frame after camera event"
    assert _wait(lambda: (_state(base)["stats"] or {}).get("preview")
                 is False), "never switched back to full res"
    assert app._last_frame.pixels.shape == (H, W, 3)


def test_unknown_routes_404(viewer):
    _, base, _, _ = viewer
    for call in (lambda: _get(base, "/api/nope"),
                 lambda: _post(base, "/api/nope", {}),
                 lambda: _post(base, "/api/instance/0/nope", {})):
        with pytest.raises(urllib.error.HTTPError) as e:
            call()
        assert e.value.code == 404


def test_api_error_returns_500(viewer):
    _, base, _, _ = viewer
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "/api/instance/99/update", {"position": [0, 0, 0]})
    assert e.value.code == 500


def test_keypress_latency_instrumented(viewer):
    """The first frame after a key carries input_latency_ms = wait_ms +
    render_ms; later frames carry none."""
    app, base, _, _ = viewer
    assert _wait(lambda: _state(base)["stats"] is not None)
    before = app.engine.last_event_frame
    app.key("E")
    assert _wait(lambda: app.engine.last_event_frame is not before,
                 interval=0.01), "no frame carried the keypress latency"
    tagged = app.engine.last_event_frame
    assert tagged.wait_ms is not None
    assert tagged.input_latency_ms == pytest.approx(
        tagged.wait_ms + tagged.render_ms, abs=1.0)
    assert 0.0 <= tagged.wait_ms <= tagged.input_latency_ms
    assert _wait(lambda: (_state(base)["stats"] or {}).get(
        "input_latency_ms") is not None)

    def advanced_past():
        f = app._last_frame
        return (f is not None and f.input_latency_ms is None
                and f.frame_number > tagged.frame_number
                and app.engine.last_event_frame is tagged)
    assert _wait(advanced_past)


def test_main_parses_and_refuses_cuda_without_a_card(monkeypatch):
    from raytracer_tpu_torch.apps import viewer as viewer_app

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        viewer_app.main(["--port", "0", "--width", "32", "--height", "16"])
