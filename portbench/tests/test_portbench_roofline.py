"""The rooflines' byte model: a share is 100% exactly when the kernel
time equals the least time, never more for a slower kernel, and nothing
when the kernel did not run."""

import os
import types

import pytest

import pbtest
from portbench import harness

PEAKS = {"hbm_bytes_per_s": 3.35e12}


class _Trace:
    def __init__(self, seconds):
        self.seconds = seconds

    def kernel_s(self, pattern):
        return self.seconds


def _ctx(seconds, frames=3, primaries=3 * 921600, rays=3 * 2_500_000,
         triangles=49298):
    return types.SimpleNamespace(trace=_Trace(seconds), peaks=PEAKS,
                                 frames=frames, primaries=primaries,
                                 rays=rays, triangles=triangles)


@pytest.mark.parametrize("metric", ["roofline.trace4", "roofline.bounce12"])
def test_share_is_at_most_100_percent(metric):
    path = os.path.join(pbtest.ROOT, "portbench", "metrics", f"{metric}.py")
    ns = {}
    exec(compile(open(path).read(), path, "exec"), ns)
    ctx = _ctx(1.0)
    rays = (ctx.primaries if metric.endswith("trace4")
            else ctx.rays - ctx.primaries)
    least = (rays * ns["RAY_BYTES"] + ctx.frames * ctx.triangles
             * ns["TRI_BYTES"]) / PEAKS["hbm_bytes_per_s"]
    read = harness.reader(metric)
    assert read(_ctx(least)) == pytest.approx(100.0)
    assert read(_ctx(2.0 * least)) == pytest.approx(50.0)
    assert read(_ctx(0.0)) is None
    assert read(types.SimpleNamespace(**{**vars(_ctx(least)),
                                         "peaks": None})) is None
