"""The port's utils: ``load_config`` precedence (defaults < .env file <
environment < overrides), the stage timer and frame counter, the
``torch.profiler`` trace and the stage loggers."""

import json
import logging
import time

import pytest

from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.utils import config, log, profiler


def test_load_config_precedence(tmp_path, monkeypatch):
    env = tmp_path / "render.env"
    env.write_text("# a comment\nRAYTPU_WIDTH=320\nRAYTPU_HEIGHT='200'\n"
                   "RAYTPU_MAX_BOUNCES=6\nRAYTPU_EMISSIVE_EMITS=no\n"
                   "not a pair\n")
    monkeypatch.chdir(tmp_path)
    for k in ("RAYTPU_WIDTH", "RAYTPU_HEIGHT", "RAYTPU_MAX_BOUNCES",
              "RAYTPU_EMISSIVE_EMITS", "RAYTPU_FUZZ"):
        monkeypatch.delenv(k, raising=False)
    assert config.load_config() == RenderConfig()           # no .env here
    cfg = config.load_config(str(env))
    assert (cfg.width, cfg.height, cfg.max_bounces) == (320, 200, 6)
    assert cfg.emissive_emits is False and cfg.fuzz == 0.3
    monkeypatch.setenv("RAYTPU_WIDTH", "640")
    monkeypatch.setenv("RAYTPU_FUZZ", "0.5")
    cfg = config.load_config(str(env))
    assert (cfg.width, cfg.height, cfg.fuzz) == (640, 200, 0.5)
    cfg = config.load_config(str(env), width=800, kernel="wavefront")
    assert (cfg.width, cfg.height, cfg.kernel) == (800, 200, "wavefront")
    (tmp_path / ".env").write_text("RAYTPU_HEIGHT=100\n")
    assert config.load_config().height == 100                # ./.env
    monkeypatch.setenv("RAYTPU_RNG_MODE", "nonsense")
    with pytest.raises(ValueError):
        config.load_config()


def test_stage_timer_aggregates():
    t = profiler.StageTimer()
    for _ in range(3):
        with t.stage("build"):
            time.sleep(0.002)
    with pytest.raises(KeyError):
        with t.stage("upload"):
            raise KeyError("failed stages still count")
    s = t.summary()
    assert s["build"]["count"] == 3 and s["upload"]["count"] == 1
    assert s["build"]["total_ms"] >= 6.0
    assert s["build"]["mean_ms"] == pytest.approx(
        s["build"]["total_ms"] / 3, abs=0.01)
    t.reset()
    assert t.summary() == {}


def test_frame_counter_window(monkeypatch):
    now = [100.0]
    monkeypatch.setattr(profiler.time, "perf_counter", lambda: now[0])
    fc = profiler.FrameCounter(window_s=1.0)
    assert fc.fps == 0.0 and fc.mrays_per_s == 0.0
    for _ in range(5):
        fc.tick(rays=2e6)
        now[0] += 0.25
    assert fc.fps == pytest.approx(4.0)
    assert fc.mrays_per_s == pytest.approx(8.0)
    now[0] += 5.0
    fc.tick(rays=1e6)
    assert fc.fps == 0.0   # the window holds one frame


def test_device_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with profiler.device_trace(None):
        torch.ones(4).sum()
    assert not list(tmp_path.iterdir())
    with profiler.device_trace(str(tmp_path / "tr")):
        (torch.ones(64) * 2).sum()
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_stage_loggers():
    lg = log.get_logger("srt")
    assert lg.name == "raytpu.srt" and isinstance(lg, logging.Logger)
    assert log.get_logger("srt") is lg
