"""The three-thread runtime: UI / render loop / scene rebuild.

The port of ``raytracer_tpu/engine/loop.py``, with the same single-writer
discipline as the reference's "(3-THREAD-RACE-CONDITION-FIX)" comments
(``VulkanApp.java:34-38``, ``VulkanEngine.java:34-41``):

* the app / UI owns all mutable state (camera, scene graph, counters);
* the render thread ("VRT") drains drain-to-latest mailboxes (camera,
  scene) and enqueues frames; a publisher thread ("PUB") emits them in
  order into a latest-frame mailbox;
* scene rebuilds ("SRT") run in a pool of one; on completion the new
  scene is swapped in and accumulation resets.

A rebuild failure keeps the old scene rendering (``VulkanApp.java:
270-272``), a render-step failure is logged and the loop goes on, and
``stop()`` joins with a 5 s timeout (``VulkanEngine.java:142-150``).

Streams: the SRT and the render thread both launch on the card's default
stream (PyTorch's current stream in every thread), so a render after a
swap is ordered after the kernels that built its scene, with no event to
pass. Readback: the render thread enqueues each frame's device -> host
copy into pinned memory right after the frame and records an event; a
reader pool of two waits on that event, and the publisher waits on the
reader, so the render thread never blocks on a readback.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

from raytracer_tpu_torch import knobs
from raytracer_tpu_torch.core.types import RenderConfig, to_device
from raytracer_tpu_torch.engine.renderer import Renderer
from raytracer_tpu_torch.scene.builder import (build_fast_scene,
                                               build_gpu_scene)
from raytracer_tpu_torch.scene.scene import Scene
from raytracer_tpu_torch.utils.log import get_logger
from raytracer_tpu_torch.utils.profiler import FrameCounter, StageTimer

_log_vrt = get_logger("vrt")
_log_srt = get_logger("srt")


@dataclasses.dataclass
class FrameData:
    """VRT -> UI frame mailbox payload (reference renderer/FrameData.java,
    with its statistics)."""

    pixels: np.ndarray          # u8[H, W, 3]
    frame_number: int
    samples: float
    rays_traced: float
    # Dispatch-to-publish latency: with RAYTPU_PIPELINE frames in flight
    # it includes queue dwell; FrameCounter's rolling FPS is throughput.
    render_ms: float
    # True while the resolution ladder serves upscaled preview frames.
    preview: bool = False
    # Input-event -> this-frame-published latency, on the first frame
    # rendered with post-event state only: ``wait_ms`` = event -> dispatch
    # start, render_ms = dispatch -> publish (readback included).
    input_latency_ms: Optional[float] = None
    wait_ms: Optional[float] = None


class _Mailbox:
    """Drain-to-latest single-slot mailbox."""

    def __init__(self):
        self._lock = threading.Lock()
        self._value = None
        self._fresh = False

    def put(self, value) -> None:
        with self._lock:
            self._value = value
            self._fresh = True

    def take(self):
        """Return (value, fresh) and clear the fresh flag."""
        with self._lock:
            fresh = self._fresh
            self._fresh = False
            return self._value, fresh


def _host_frame(event, pixels: torch.Tensor, rays: torch.Tensor):
    """Reader-pool side of a card readback: wait for the frame's copy
    event -> (u8 pixels, rays traced)."""
    event.synchronize()
    return pixels.numpy(), float(rays)


class RenderEngine:
    """Owns the render and publisher threads and the rebuild pool."""

    def __init__(self, config: Optional[RenderConfig] = None,
                 renderer: Optional[Renderer] = None,
                 device_rebuild: bool = True,
                 ladder_frames: Optional[int] = None, device="cuda"):
        if torch.device(device).type == "cuda" and \
                not torch.cuda.is_available():
            raise RuntimeError("RenderEngine(device='cuda') needs a CUDA "
                               "device; pass device='cpu'")
        self.device = device
        self._cuda = torch.device(device).type == "cuda"
        self.cfg = config or RenderConfig()
        self.renderer = renderer or Renderer(self.cfg)
        # Resolution ladder: while frame_count < ladder_frames (every
        # accumulation-resetting event zeroes it), render at 1/scale per
        # axis and upscale; then full resolution with the counter shifted
        # so the first full frame overwrites. RAYTPU_LADDER applies only
        # when the caller passes None, as in the JAX package.
        if ladder_frames is None:
            ladder_frames = knobs.count("RAYTPU_LADDER", 0)
        self._ladder_frames = int(ladder_frames)
        self._preview: Optional[Renderer] = None
        scale = max(2, knobs.count("RAYTPU_LADDER_SCALE", 2))
        if (self._ladder_frames > 0
                and self.cfg.width % (8 * scale) == 0
                and self.cfg.height % (8 * scale) == 0):
            self._preview = Renderer(dataclasses.replace(
                self.cfg, width=self.cfg.width // scale,
                height=self.cfg.height // scale))
        # Live edits build on the device (packet scenes only; per-ray
        # scenes use the host builder).
        self._device_builder = None
        if device_rebuild and self.cfg.kernel == "packet":
            from raytracer_tpu_torch.scene.device_builder import \
                DeviceSceneBuilder

            self._device_builder = DeviceSceneBuilder(device)
        self.profiler = StageTimer()
        self.meter = FrameCounter()
        self._camera_box = _Mailbox()
        self._scene_box = _Mailbox()
        self._frame_box = _Mailbox()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._publisher: Optional[threading.Thread] = None
        self._readback_pool = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="RB")
        self._pending = collections.deque()
        self._pending_cv = threading.Condition()
        self._rebuild_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="SRT")
        self._build_in_flight = threading.Event()
        self._frame_number = 0
        self.on_scene_swapped: Optional[Callable[[], None]] = None
        # The latest user event's keypress -> frame latency (ms) and its
        # whole tagged frame (the frame mailbox drains to latest).
        self.last_input_latency_ms: Optional[float] = None
        self.last_event_frame: Optional[FrameData] = None

    # --- submission API (UI thread side) -----------------------------------

    def submit_camera_update(self, uniforms) -> None:
        self._camera_box.put(uniforms)

    def submit_scene(self, device_scene) -> None:
        """Swap in an already-built device scene."""
        self._scene_box.put(device_scene)

    def rebuild_scene_async(self, scene: Scene,
                            on_done: Optional[Callable] = None):
        """Snapshot + background build + swap (the SRT path,
        VulkanApp.rebuildSceneAsync, :242-304). Returns the future, or
        None while another rebuild is in flight."""
        if self._build_in_flight.is_set():
            _log_srt.info("rebuild already in flight; skipping")
            return None
        self._build_in_flight.set()
        snapshot = scene.create_snapshot()

        def work():
            t0 = time.perf_counter()
            try:
                with self.profiler.stage("build"):
                    if self._device_builder is not None:
                        built = self._device_builder.build(snapshot)
                    elif self.cfg.kernel == "packet":
                        built = build_fast_scene(snapshot,
                                                 device=self.device)
                    else:
                        built = build_gpu_scene(snapshot,
                                                device=self.device)
                self._scene_box.put(built)
                _log_srt.info("rebuild done in %.1f ms",
                              (time.perf_counter() - t0) * 1e3)
                return built
            except Exception:
                _log_srt.exception("scene rebuild failed; keeping old scene")
                raise
            finally:
                self._build_in_flight.clear()
                if on_done is not None:
                    on_done()

        return self._rebuild_pool.submit(work)

    @property
    def build_in_progress(self) -> bool:
        """The UI pauses accumulation while true (VulkanApp.java:
        199-208)."""
        return self._build_in_flight.is_set()

    # --- frame consumption (UI thread side) ---------------------------------

    def latest_frame(self) -> Optional[FrameData]:
        frame, fresh = self._frame_box.take()
        return frame if fresh else None

    # --- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._main_loop, name="VRT",
                                        daemon=True)
        self._publisher = threading.Thread(target=self._publish_loop,
                                           name="PUB", daemon=True)
        self._thread.start()
        self._publisher.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._running = False
        with self._pending_cv:
            self._pending_cv.notify_all()
        for t, what in ((self._thread, "render thread"),
                        (self._publisher, "publisher")):
            # The publisher drains the in-flight tail before exiting, so
            # the last submitted frame is never lost.
            if t is not None:
                t.join(timeout)
                if t.is_alive():
                    _log_vrt.warning("%s did not stop in %.1fs", what,
                                     timeout)
        self._rebuild_pool.shutdown(wait=False)
        self._readback_pool.shutdown(wait=False)

    # --- the render loop (VRT) ----------------------------------------------

    def _main_loop(self) -> None:
        _log_vrt.info("render thread started")
        scene = cam = accum = accum_p = None
        # Pipelined dispatch: up to ``depth`` frames in flight ahead of
        # the publisher (RAYTPU_PIPELINE; 1 in ladder sessions, so at
        # most one full frame sits ahead of a keypress preview, else 2).
        depth = max(1, knobs.count("RAYTPU_PIPELINE",
                                   1 if self._preview is not None else 2))
        last_fc = 0
        pending_event_t = None  # keypress time awaiting its first frame
        last_event_t = None     # latest user-action stamp already seen
        try:
            while self._running:
                new_scene, scene_fresh = self._scene_box.take()
                if scene_fresh:
                    # Let the publisher flush in-flight frames, then swap.
                    self._drain_pending()
                    scene = new_scene
                    accum = accum_p = None
                    if self.on_scene_swapped is not None:
                        self.on_scene_swapped()
                new_cam, cam_fresh = self._camera_box.take()
                if cam_fresh:
                    cam = new_cam
                    # A user action (its ``event_t`` stamp changed, or,
                    # without a stamp, the counter went backward) drops
                    # the stale in-flight frames so the first new-state
                    # frame does not queue behind them. Tick submissions
                    # with a growing counter must not drop frames.
                    fc_now = self._host_fc(cam)
                    ev = getattr(cam, "event_t", None)
                    if ev is not None and ev != last_event_t:
                        last_event_t = ev
                        self._clear_pending()
                        pending_event_t = float(ev)
                    elif ev is None and fc_now < last_fc:
                        self._clear_pending()
                        pending_event_t = time.perf_counter()
                    last_fc = fc_now

                if scene is None or cam is None:
                    time.sleep(0.016)  # idle until scene + camera arrive
                    continue

                # Backpressure: previews wait for a drained pipe, full
                # frames run up to ``depth`` ahead of the publisher.
                fc = self._host_fc(cam)
                preview = (self._preview is not None
                           and fc < self._ladder_frames)
                with self._pending_cv:
                    room = len(self._pending) <= (0 if preview else depth)
                if not room:
                    time.sleep(0.001)
                    continue

                try:
                    t0 = time.perf_counter()
                    if preview:
                        if accum_p is None:
                            accum_p = self._preview.new_accumulator(
                                self.device)
                        with self.profiler.stage("dispatch"):
                            accum_p, image, stats = self._preview.render(
                                scene, cam, accum_p)
                    else:
                        if accum is None:
                            # frame_count 0 overwrites the buffer anyway.
                            accum = self.renderer.new_accumulator(
                                self.device)
                        cam_r = cam
                        if self._preview is not None:
                            # Shift the counter so the first full frame
                            # after a preview burst overwrites the buffer.
                            shifted = max(0, fc - self._ladder_frames)
                            cam_r = dataclasses.replace(
                                cam, fc_host=shifted,
                                frame_count=to_device(np.int32(shifted),
                                                      self.device))
                        with self.profiler.stage("dispatch"):
                            accum, image, stats = self.renderer.render(
                                scene, cam_r, accum)
                    fut = self._start_readback(image, stats["rays_traced"])
                    with self._pending_cv:
                        self._pending.append((fut, stats["samples"], t0,
                                              preview, pending_event_t))
                        self._pending_cv.notify_all()
                    pending_event_t = None
                except Exception:
                    _log_vrt.exception("render step failed; continuing")
                    self._clear_pending()
                    time.sleep(0.1)
        finally:
            _log_vrt.info("render thread exiting")

    def _start_readback(self, image: torch.Tensor, rays: torch.Tensor):
        """Start a frame's device -> host fetch -> future of (pixels,
        rays). On the card: copies into pinned memory, enqueued after the
        frame, and an event the reader pool waits on."""
        if not self._cuda:
            return self._readback_pool.submit(
                lambda: (image.numpy().copy(), float(rays)))
        pixels = torch.empty(image.shape, dtype=image.dtype,
                             pin_memory=True)
        rays_h = torch.empty((), dtype=rays.dtype, pin_memory=True)
        pixels.copy_(image, non_blocking=True)
        rays_h.copy_(rays, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return self._readback_pool.submit(_host_frame, event, pixels,
                                          rays_h)

    def _publish_loop(self) -> None:
        """Pop in order, wait for the readback, publish. Exits once
        stopped AND drained (the stop() flush guarantee)."""
        _log_vrt.info("publisher thread started")
        try:
            while True:
                with self._pending_cv:
                    while not self._pending and self._running:
                        self._pending_cv.wait(0.05)
                    if not self._pending:
                        if not self._running:
                            return
                        continue
                    entry = self._pending.popleft()
                    self._pending_cv.notify_all()  # wake VRT backpressure
                fut, samples, t0, preview, event_t = entry
                try:
                    with self.profiler.stage("readback"):
                        pixels, rays = fut.result()
                    self._publish(pixels, samples, rays, t0, preview,
                                  event_t)
                except Exception:
                    _log_vrt.exception("frame readback failed; continuing")
        finally:
            _log_vrt.info("publisher thread exiting")

    def _clear_pending(self) -> None:
        """Drop unpublished in-flight frames (stale after a user event);
        their readbacks finish in the background and are discarded."""
        with self._pending_cv:
            self._pending.clear()
            self._pending_cv.notify_all()

    def _drain_pending(self, timeout: float = 30.0) -> None:
        """Wait until the publisher has emitted every in-flight frame."""
        deadline = time.monotonic() + timeout
        with self._pending_cv:
            while self._pending and time.monotonic() < deadline:
                self._pending_cv.wait(0.05)

    @staticmethod
    def _host_fc(cam) -> int:
        """The accumulation counter from its host mirror; only uniforms
        without one (``fc_host`` None) read the device."""
        fc = getattr(cam, "fc_host", None)
        if fc is None:
            fc = int(cam.frame_count)
        return int(fc)

    def _publish(self, pixels: np.ndarray, samples, rays: float, t_submit,
                 preview=False, event_t=None) -> None:
        """Publisher thread only (single writer of the meter, the frame
        mailbox and the latency fields)."""
        if preview:
            # Upscale to the full frame size: consumers see one shape.
            fy = self.cfg.height // pixels.shape[0]
            fx = self.cfg.width // pixels.shape[1]
            pixels = pixels.repeat(fy, axis=0).repeat(fx, axis=1)
        now = time.perf_counter()
        latency = wait = None
        if event_t is not None:
            latency = (now - event_t) * 1e3
            wait = (t_submit - event_t) * 1e3
            self.last_input_latency_ms = latency
        self._frame_number += 1
        self.meter.tick(rays)
        frame = FrameData(
            pixels=pixels, frame_number=self._frame_number,
            samples=float(samples), rays_traced=rays,
            render_ms=(now - t_submit) * 1e3, preview=preview,
            input_latency_ms=latency, wait_ms=wait)
        if event_t is not None:
            self.last_event_frame = frame
        self._frame_box.put(frame)
