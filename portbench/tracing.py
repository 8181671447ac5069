"""The traced run's instruments and the reduction of what they record.

* ``Spans``: the benchmark's own spans around program functions (a
  wrapper that adds host time by span name and marks the call with a
  ``record_function`` range), put in place only for a traced run.
* ``Capture``: ``torch.profiler`` over the window (CPU and CUDA
  activities), with PyTorch's sync debug mode counting synchronising CUDA
  calls as warnings.
* ``Trace``: the recorded events as arrays, and what the readers take
  from them: the window, device intervals, busy time, kernel time by name
  and the idle gaps by what the host thread was doing meanwhile.
"""

from __future__ import annotations

import contextlib
import re
import threading
import time
import warnings
from collections import defaultdict

import numpy as np
import torch

from portbench import stats

WINDOW_SPAN = "portbench.window"
SPAN_PREFIX = "portbench."


class Spans:
    """Host seconds and calls inside wrapped functions, by span name. A
    call nested in one of the same name counts once, in the outer."""

    def __init__(self):
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._undo = []

    def wrap(self, owner, attr: str, name: str) -> None:
        """Replace ``owner.attr`` (a module function or a class's method)
        by a wrapper that books span ``name``."""
        original = getattr(owner, attr)
        local, lock = self._local, self._lock
        label = SPAN_PREFIX + name
        seconds, calls = self.seconds, self.calls

        def wrapper(*args, **kwargs):
            if getattr(local, name, False):
                return original(*args, **kwargs)
            setattr(local, name, True)
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(label):
                    return original(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                setattr(local, name, False)
                with lock:
                    seconds[name] += dt
                    calls[name] += 1

        setattr(owner, attr, wrapper)
        self._undo.append((owner, attr, original))

    def reset(self) -> None:
        with self._lock:
            self.seconds.clear()
            self.calls.clear()

    def snapshot(self) -> dict:
        """{span name: (seconds, calls)} as it stands."""
        with self._lock:
            return {n: (self.seconds[n], self.calls[n]) for n in self.calls}

    def restore(self) -> None:
        for owner, attr, original in reversed(self._undo):
            setattr(owner, attr, original)
        self._undo.clear()


class Capture:
    """The profiler and the sync counter over a block. ``syncs`` is the
    number of synchronising CUDA calls seen (None off the card)."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.syncs = None
        self.prof = None
        self._stack = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self._stack = contextlib.ExitStack()
        self.prof = self._stack.enter_context(profile(activities=acts))
        if self.cuda:
            self._caught = self._stack.enter_context(
                warnings.catch_warnings(record=True))
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.set_sync_debug_mode(0)
            self.syncs = sum("synchroniz" in str(w.message)
                             for w in self._caught)
        self._stack.close()
        return False


class Trace:
    """A profile's events as arrays: name, start and end (ns), on the
    device or not, thread, activity type."""

    def __init__(self, prof):
        names, t0, t1, dev, thr, kind = [], [], [], [], [], []
        for row in _rows(prof):
            for column, value in zip((names, t0, t1, dev, thr, kind), row):
                column.append(value)
        self.names = names
        self.t0 = np.asarray(t0, np.int64)
        self.t1 = np.asarray(t1, np.int64)
        self.on_device = np.asarray(dev, bool)
        self.thread = np.asarray(thr, np.int64)
        kind = np.asarray(kind, object)
        span = np.array([n.startswith(SPAN_PREFIX) for n in names], bool)
        note = np.array(["annotation" in str(k) for k in kind], bool)
        self.device_work = self.on_device & ~span & ~note
        self.kinds = dict(zip(*np.unique(kind.astype(str),
                                         return_counts=True))) if len(
            kind) else {}
        wins = [i for i, n in enumerate(names)
                if n == WINDOW_SPAN and not self.on_device[i]]
        if not wins:
            raise RuntimeError("the trace holds no window span")
        w = max(wins, key=lambda i: self.t1[i] - self.t0[i])
        self.w0, self.w1 = int(self.t0[w]), int(self.t1[w])

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e9

    def _device(self):
        idx = np.nonzero(self.device_work & (self.t1 > self.w0)
                         & (self.t0 < self.w1))[0]
        return idx

    def device_count(self) -> int:
        """Device activities (kernels, copies, memsets) in the window."""
        return int(self._device().size)

    def busy_s(self) -> float:
        """Union of device intervals within the window, in seconds."""
        idx = self._device()
        iv = stats.clip(zip(self.t0[idx], self.t1[idx]), self.w0, self.w1)
        return stats.union_length(iv) / 1e9

    def kernel_s(self, pattern: str) -> float:
        """Device seconds within the window of activities whose name
        matches the regular expression."""
        rx = re.compile(pattern)
        total = 0
        for i in self._device():
            if rx.search(self.names[i]):
                total += (min(self.t1[i], self.w1)
                          - max(self.t0[i], self.w0))
        return total / 1e9

    def top_ops(self, k: int = 10):
        """[[name, seconds]] of the device activities with the most time
        in the window, summed by the first 80 characters of the name."""
        by = defaultdict(int)
        for i in self._device():
            by[self.names[i][:80]] += (min(self.t1[i], self.w1)
                                       - max(self.t0[i], self.w0))
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n, v / 1e9] for n, v in top]

    def idle_gaps(self, k: int = 10):
        """[[name, seconds]]: the window's idle device time summed by what
        the thread that launches most kernels was running at each gap's
        midpoint: its innermost CPU op, else "python in <span>" for the
        innermost benchmark span around that moment, else "python (no
        op)"; the k largest."""
        idx = self._device()
        gaps = stats.gaps(zip(self.t0[idx], self.t1[idx]), self.w0, self.w1)
        host = np.nonzero(~self.on_device & (self.t1 > self.w0)
                          & (self.t0 < self.w1))[0]
        if host.size:
            launch = np.array([self.names[i] == "cudaLaunchKernel"
                               for i in host], bool)
            pool = host[launch] if launch.any() else host
            ids, counts = np.unique(self.thread[pool], return_counts=True)
            busiest = ids[np.argmax(counts)]
            host = host[self.thread[host] == busiest]
        is_span = np.array([self.names[i].startswith(SPAN_PREFIX)
                            for i in host], bool)
        ops = _by_start(host[~is_span], self.t0)
        spans = _by_start(host[is_span], self.t0)
        by = defaultdict(int)
        for g0, g1 in gaps:
            mid = (g0 + g1) // 2
            i = self._innermost(ops, mid)
            if i is not None:
                name = self.names[i][:80]
            else:
                i = self._innermost(spans, mid, skip=WINDOW_SPAN)
                name = ("python (no op)" if i is None
                        else "python in " + self.names[i][:60])
            by[name] += g1 - g0
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n, v / 1e9] for n, v in top]

    def _innermost(self, order, t: int, skip: str = "", depth: int = 32):
        """The latest-starting event of ``order`` (indices sorted by
        start) that contains time t, looking back at most ``depth``
        events (nested host events on one thread: the innermost)."""
        idx, starts = order
        j = int(np.searchsorted(starts, t, side="right")) - 1
        stop = max(-1, j - depth)
        while j > stop:
            i = idx[j]
            if self.t1[i] > t and self.names[i] != skip:
                return i
            j -= 1
        return None


def _kind(name: str, on_device: bool) -> str:
    """An event's activity type where the profiler does not say it: the
    benchmark's spans are annotations, other device events are work."""
    if name.startswith(SPAN_PREFIX):
        return "gpu_user_annotation" if on_device else "user_annotation"
    return "kernel" if on_device else "cpu_op"


def _rows(prof):
    """(name, start ns, end ns, on device, thread, activity type) of each
    recorded event: from the profiler's raw results where it has them
    (fast), else from its event list."""
    cuda = torch.autograd.DeviceType.CUDA
    results = getattr(prof.profiler, "kineto_results", None)
    events = results.events() if results is not None else None
    if events is None:
        for e in prof.events():
            on = e.device_type == cuda
            yield (e.name, int(e.time_range.start * 1e3),
                   int(e.time_range.end * 1e3), on, e.thread,
                   _kind(e.name, on))
        return
    probe = events[0] if len(events) else None
    has_kind = probe is not None and hasattr(probe, "activity_type")
    has_thread = probe is not None and hasattr(probe, "start_thread_id")
    for e in events:
        name = e.name()
        on = e.device_type() == cuda
        yield (name, e.start_ns(), e.end_ns(), on,
               e.start_thread_id() if has_thread else 0,
               e.activity_type() if has_kind else _kind(name, on))


def _by_start(idx, t0):
    idx = idx[np.argsort(t0[idx], kind="stable")]
    return idx, t0[idx]
