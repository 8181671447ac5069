"""Stage timing and frame statistics: nestable wall-time stage timers with
per-stage aggregates, a rolling FPS + Mrays/s counter (the JAX package's
``utils/profiler.py``), and ``device_trace``, a ``torch.profiler`` trace
of a block written as a Chrome trace."""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Optional

from raytracer_tpu_torch.utils.log import get_logger

_log = get_logger("prof")


class StageTimer:
    """Aggregating wall-time profiler for pipeline stages."""

    def __init__(self):
        self._totals = collections.defaultdict(float)
        self._counts = collections.defaultdict(int)
        self._last = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._totals[name] += dt
            self._counts[name] += 1
            self._last[name] = dt
            _log.debug("%s: %.2f ms", name, dt * 1e3)

    def summary(self) -> dict:
        return {
            name: {
                "total_ms": round(self._totals[name] * 1e3, 2),
                "count": self._counts[name],
                "mean_ms": round(
                    self._totals[name] / self._counts[name] * 1e3, 2),
                "last_ms": round(self._last[name] * 1e3, 2),
            }
            for name in self._totals
        }

    def reset(self) -> None:
        self._totals.clear()
        self._counts.clear()
        self._last.clear()


class FrameCounter:
    """Rolling FPS / Mrays-per-second meter over a ``window_s`` window."""

    def __init__(self, window_s: float = 1.0):
        self.window_s = window_s
        self._frames = collections.deque()  # (t, rays)

    def tick(self, rays: float = 0.0) -> None:
        now = time.perf_counter()
        self._frames.append((now, rays))
        while self._frames and now - self._frames[0][0] > self.window_s:
            self._frames.popleft()

    @property
    def fps(self) -> float:
        if len(self._frames) < 2:
            return 0.0
        span = self._frames[-1][0] - self._frames[0][0]
        return (len(self._frames) - 1) / span if span > 0 else 0.0

    @property
    def mrays_per_s(self) -> float:
        if len(self._frames) < 2:
            return 0.0
        span = self._frames[-1][0] - self._frames[0][0]
        rays = sum(r for _, r in list(self._frames)[1:])
        return rays / span / 1e6 if span > 0 else 0.0


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Trace the block with ``torch.profiler`` (host and, where there is a
    card, CUDA activity) and write ``log_dir/trace.json`` (Chrome trace
    format) when a log dir is given; no-op otherwise."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
