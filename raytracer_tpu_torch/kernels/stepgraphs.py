"""Static buffers and replayed CUDA graphs for the bounce engine's steps.

The sorted rounds (``kernels/wavefront.py``) run as fixed-width steps: a
round at width W, a shrink from W to W', a band's hand-off, a ladder's
last deposit and the tail's entry. Each step reads and writes buffers of
a space, and the space runs it:

* ``Space`` (the plain space): buffers made anew for each ladder call,
  steps run eagerly;
* ``Workspace``: one scene's buffers on one card, made once per (role,
  name, shape), and each step captured once as a CUDA graph (all of a
  ladder's steps at once, the first time the ladder runs there) and
  replayed after. The host keeps only the loop's decisions: it reads the
  live count after each round, as it does eagerly.

The rule that engages a workspace observes its input and has no switch:
the scene is on the card, no ``launches.plain_versions()`` context is
open, the engine is a fused one (``GRAPHED``; the split engine's rounds
stay eager), and the same scene object renders the same ladder a second
time (``begin_render``, which the renderer calls once a frame, counts the
renders). So a scene rebuilt every frame (a drag, a live edit) stays
eager and pays no capture: a render that captures costs two to five
eager ones (``chip_smoke.py`` phase 14). One scene's workspace is kept per device, for
the thread that renders it: a new scene replaces it, and its graphs and
buffers go with it. Until then the workspace holds its scene, its static
buffers and its graph pool, also after the caller has dropped the scene;
``reset()`` frees them. Captures run with ``capture_error_mode=
"thread_local"``, so another thread (the engine loop's scene rebuild)
may launch work meanwhile.

A graph bakes in the host values of its capture; ``step_key`` lists them
and keys the graph by them. A value that changes from frame to frame (the
hand-off's bounce budget) stays outside every graph.
"""

from __future__ import annotations

import collections
import threading

import torch

from raytracer_tpu_torch.kernels import launches

# The round engines whose steps are captured.
GRAPHED = ("fused12", "fused", "fused_packed")


def step_key(ladder: tuple, kind: str, *args) -> tuple:
    """The key of a step's graph: the ladder's host values (``ladder``,
    ``wavefront._Ladder.key``) and the step's own (its kind and widths,
    bounces a round, walk order)."""
    return ladder + (kind,) + args


class Space:
    """The plain space: fresh buffers, every step run eagerly."""

    static = False

    def buf(self, name: tuple, shape, dtype, device) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, device=device)

    def prepare(self, ladder: tuple, steps, keep=()) -> None:
        """Nothing to capture."""

    def run(self, key: tuple, kind: str, fn) -> None:
        launches.graphs["eager." + kind] += 1
        fn()


PLAIN = Space()


class Workspace(Space):
    """One scene's static buffers and step graphs on one device."""

    static = True

    def __init__(self, scene):
        self.scene = scene
        self.device = torch.device(scene.device)
        self.thread = threading.get_ident()
        self.renders = 0
        self.first: dict = {}      # ladder key -> render that first ran it
        self.prepared: set = set()  # ladder keys whose steps are captured
        self.bufs: dict = {}
        self.graphs: dict = {}     # step key -> (graph, launches booked)
        self.pool = None
        self.stream = None
        self.pool_bytes = 0        # device memory the captures reserved

    def buf(self, name: tuple, shape, dtype, device) -> torch.Tensor:
        k = (name, tuple(shape), dtype)
        t = self.bufs.get(k)
        if t is None:
            t = self.bufs[k] = torch.zeros(shape, dtype=dtype, device=device)
        return t

    def buffer_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.bufs.values())

    def prepare(self, ladder: tuple, steps, keep=()) -> None:
        """Capture, once for the ladder ``ladder``, every (key, kind, fn)
        that ``steps()`` lists and no graph holds yet. Each runs once
        eagerly first, which loads its kernels outside the capture;
        ``keep`` lists the buffers those runs may not change (restored
        after them). Neither the runs nor the captures book launches:
        ``launches.kernel`` counts a frame's own."""
        if ladder in self.prepared:
            return
        todo = [s for s in steps() if s[0] not in self.graphs]
        saved = [t.clone() for t in keep]
        before = collections.Counter(launches.kernel)
        for _, _, fn in todo:
            fn()
        _unbook(launches.kernel - before)
        for t, s in zip(keep, saved):
            t.copy_(s)
        del saved
        reserved = self._reserved()
        for key, kind, fn in todo:
            self.graphs[key] = self._capture(fn)
            launches.graphs["capture." + kind] += 1
        self.pool_bytes += self._reserved() - reserved
        self.prepared.add(ladder)

    def run(self, key: tuple, kind: str, fn) -> None:
        graph, booked = self.graphs[key]
        self._replay(graph)
        launches.kernel.update(booked)
        launches.graphs["replay." + kind] += 1

    def _capture(self, fn):
        """-> (graph, the launches ``fn`` books): a capture launches
        nothing, so its bookings move to each replay."""
        before = collections.Counter(launches.kernel)
        graph = self._record(fn)
        booked = launches.kernel - before
        _unbook(booked)
        return graph, booked

    def _record(self, fn):
        """Capture ``fn``'s launches on a side stream into a graph of the
        workspace's memory pool (one pool for all its graphs: they replay
        one at a time, on one stream)."""
        dev = self.device
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(dev)
        current = torch.cuda.current_stream(dev)
        self.stream.wait_stream(current)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool,
                                capture_error_mode="thread_local")
            try:
                fn()
            finally:
                graph.capture_end()
        current.wait_stream(self.stream)
        return graph

    def _replay(self, graph) -> None:
        graph.replay()

    def _reserved(self) -> int:
        return torch.cuda.memory_reserved(self.device)


def _unbook(booked: collections.Counter) -> None:
    for name, n in booked.items():
        launches.kernel[name] -= n
        if not launches.kernel[name]:
            del launches.kernel[name]


# device -> the Workspace of the scene it renders: a device's memory is the
# process's, so is the limit of one scene's graphs a device.
_spaces: dict = {}
_spaces_lock = threading.Lock()


def _card(device) -> bool:
    return launches.is_card(device)


def begin_render(scene) -> None:
    """A render of ``scene`` begins (once a frame, from the renderer): a
    new scene replaces its device's workspace; the same scene, rendered
    by the thread that owns the workspace, counts one render more."""
    if not _card(scene.device):
        return
    dev = torch.device(scene.device)
    with _spaces_lock:
        ws = _spaces.get(dev)
        if ws is None or ws.scene is not scene:
            ws = _spaces[dev] = Workspace(scene)
    if ws.thread == threading.get_ident():
        ws.renders += 1


def workspace(scene):
    """The workspace of ``scene`` that this thread may use, or None."""
    if not _card(scene.device) or launches.forced():
        return None
    ws = _spaces.get(torch.device(scene.device))
    if (ws is None or ws.scene is not scene
            or ws.thread != threading.get_ident()):
        return None
    return ws


def space(scene, ladder: tuple, engine: str) -> Space:
    """Where a ladder (``ladder``: its key) of ``scene`` keeps its buffers
    and runs its steps: the scene's workspace once the ladder ran in an
    earlier render of it, else the plain space."""
    ws = workspace(scene) if engine in GRAPHED else None
    if ws is None:
        return PLAIN
    first = ws.first.setdefault(ladder, ws.renders)
    return ws if first < ws.renders else PLAIN


def reset() -> None:
    """Drop every workspace (their graphs and buffers)."""
    _spaces.clear()
