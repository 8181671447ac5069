"""The seam that chooses between a kernel and its plain version
(``kernels/launches.py``): every kernel wrapper, and each counting build,
refuses a device that is neither the CPU nor CUDA and books nothing;
``plain_versions`` nests and restores the previous state, also on an
exception; a CPU frame books the same plain calls inside it as outside.
No card is needed: ``torch.device("cuda")`` is only a name here."""

import contextlib

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.core.camera import Camera
from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.engine.renderer import Renderer
from raytracer_tpu_torch.kernels import (bounce, keys, launches, mega,
                                         packet, tonemap, trace, tracer)
from raytracer_tpu_torch.kernels.tracer import TraversalResult
from raytracer_tpu_torch.scene.builder import build_fast_scene_from_arrays
from raytracer_tpu_torch.utils import assets

P = 128
META = torch.device("meta")


@pytest.fixture(scope="module")
def scene():
    cube = assets.make_cube() * 4.0 + np.array([0, -6, 0], np.float32)
    plane = (assets.make_ground_plane() * np.array([150, 1, 150], np.float32)
             + np.array([0, -10, 0], np.float32))
    verts = np.concatenate([plane, cube]).astype(np.float32)
    mats = np.full((verts.shape[0], 4), 0.6, np.float32)
    mats[:, 3] = 0.0
    return build_fast_scene_from_arrays(verts, mats, device="cpu")


def _camera():
    return Camera((-10.0, 6.0, 30.0), (0.0, -6.0, 0.0), vfov_deg=40.0,
                  aspect_ratio=2.0).uniforms(device="cpu")


def _m(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def _rows(*shape):
    return tuple(_m(*shape) for _ in range(3))


def _state():
    """Meta-device ray state: ray_o, ray_d, color, atten, seed, alive."""
    return (_rows(P), _rows(P), _rows(P), _rows(P),
            _m(P, dtype=torch.int64), _m(P, dtype=torch.bool))


# Wrapper -> its call on meta-device inputs (scene, cfg).
CALLS = {
    "raygen": lambda s, cfg: packet.primary_rays(_camera(), cfg, P, 0, 8, 0,
                                                 META),
    "shade": lambda s, cfg: tracer.shade(
        TraversalResult(_m(P), _m(P, dtype=torch.bool), _rows(P), _rows(P),
                        _m(P)), *_state(), True, cfg),
    "sort_key": lambda s, cfg: keys.sort_key(_rows(P), _rows(P),
                                             _m(P, dtype=torch.bool), _m(3),
                                             _m(3)),
    "trace4": lambda s, cfg: trace.trace4(s, _m(6, P),
                                          _m(P, dtype=torch.bool), cfg),
    "trace2": lambda s, cfg: trace.trace2(s, _m(6, P),
                                          _m(P, dtype=torch.bool), cfg),
    "bounce12": lambda s, cfg: bounce.bounce12(
        s, _m(bounce.STATE_ROWS, P, dtype=torch.int32), 1, True, cfg),
    "bounce15": lambda s, cfg: bounce.bounce15(
        s, _m(bounce.COLOR_ROWS, P, dtype=torch.int32), 1, True, cfg),
    "bounce_packed": lambda s, cfg: bounce.bounce_packed(
        s, _m(bounce.SF_ROWS, P), _m(1, P, dtype=torch.int32), 1, True,
        cfg),
    "mega": lambda s, cfg: mega.mega(s, *_state(), True, cfg),
    "tonemap": lambda s, cfg: tonemap.tonemap_accumulate(
        _m(8, 16, 3), _m(3, P), 1, _m(1, dtype=torch.int32), _m(1)),
    "traverse_fast": lambda s, cfg: packet._traverse_fast(
        s, _rows(P), _rows(P), _m(P, dtype=torch.bool), cfg),
    "traverse_groups": lambda s, cfg: packet._traverse_groups(
        s, _rows(64, 2), _rows(64, 2), _m(64, 2, dtype=torch.bool), cfg),
    # The counting builds run on the card only.
    "bounce_packed_count": lambda s, cfg: bounce.bounce_packed_count(
        s, _m(bounce.SF_ROWS, P), _m(1, P, dtype=torch.int32), 1, True,
        cfg),
    "mega_count": lambda s, cfg: mega.mega_count(s, *_state(), True, cfg),
}


@pytest.mark.parametrize("wrapper", list(CALLS))
def test_wrapper_refuses_another_device(scene, wrapper):
    launches.reset()
    with pytest.raises(ValueError, match="unsupported device meta"):
        CALLS[wrapper](scene, RenderConfig(width=16, height=8))
    assert not launches.plain and not launches.kernel


def test_counting_builds_refuse_the_cpu(scene):
    cfg = RenderConfig(width=16, height=8)
    sf = torch.zeros((bounce.SF_ROWS, P))
    si = torch.zeros((1, P), dtype=torch.int32)
    with pytest.raises(ValueError, match="on the card only"):
        bounce.bounce_packed_count(scene, sf, si, 1, True, cfg)
    z = torch.zeros(P)
    with pytest.raises(ValueError, match="on the card only"):
        mega.mega_count(scene, (z,) * 3, (z,) * 3, (z,) * 3, (z,) * 3,
                        torch.zeros(P, dtype=torch.int64),
                        torch.ones(P, dtype=torch.bool), True, cfg)


def test_plain_versions_nest_and_restore():
    cuda = torch.device("cuda")
    launches.reset()
    assert launches.on_card("trace4", cuda)
    with pytest.raises(RuntimeError, match="inside"):
        with launches.plain_versions("raygen"):
            assert not launches.on_card("raygen", cuda)
            assert launches.on_card("trace4", cuda)
            with launches.plain_versions():
                assert not launches.on_card("trace4", cuda)
                with launches.plain_versions("raygen"):
                    assert not launches.on_card("shade", cuda)
                assert not launches.on_card("shade", cuda)
            assert launches.on_card("shade", cuda)
            with launches.plain_versions():
                raise RuntimeError("inside")
    assert launches.on_card("raygen", cuda)
    assert launches.on_card("trace4", cuda)
    assert not launches.on_card("trace4", "cpu")
    assert dict(launches.plain) == {"raygen": 1, "trace4": 2, "shade": 2}
    assert not launches.kernel


def test_cpu_frame_books_the_same_inside_plain_versions(scene):
    cfg = RenderConfig(width=16, height=8, max_bounces=3)
    got = []
    for ctx in (contextlib.nullcontext(), launches.plain_versions()):
        launches.reset()
        with ctx:
            accum, _, _ = Renderer(cfg).render(scene, _camera())
        got.append((dict(launches.plain), accum))
        assert not launches.kernel
    (booked, want), (booked_plain, accum) = got
    assert set(booked) == {"raygen", "trace4", "shade", "sort_key",
                           "bounce12", "tonemap"}
    assert booked_plain == booked
    assert torch.equal(accum.view(torch.int32), want.view(torch.int32))
