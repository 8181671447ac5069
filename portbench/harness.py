"""One run of one cell: set-up, the window, the check, the result line.

Everything that belongs to one cell is found by name from
``BENCHMARK.json``: the configuration's file and the scene generator its
``scene.kind`` names (``portbench/scenes/<kind>.py``), the traffic mix
(``portbench/traffic/<traffic>.json``) and the driver it names
(``portbench/drivers/<driver>.py``, a ``run(env)``), the limits of the
check (``portbench/limits/<cell>.json``) and each per-layer metric's
reader (``portbench/metrics/<metric>.py``, a ``read(ctx)`` that returns a
number or None when it finds nothing to read). A later scene, driver,
cell, mix or metric is new files and entries, not an edit here.

A driver may change the scene and the camera inside the window. It is
handed the configuration, scene 0's soup, ``add_pose`` (a new camera
pose's index) and, in a traced run, the harness's spans, so it can wrap
the program function it drives (the wraps are undone after the run). Each
call names the pose and the scene it rendered; a driver that edits the
scene hands back a soup function (``Window.scenes``) that the check calls
only for the scenes its judged histories reach, each judged against its
own geometry and pose.

The program under test is ``raytracer_tpu_torch``, run as its defaults
and its configuration file state: ``run.py`` gives no result where a
``RAYTPU_*`` switch is set (``program_knobs``). The benchmark hands it the scene arrays and
camera uniforms it makes from the seed, and takes from it only its
outputs, its calls' rays-traced counters and the trace.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import sys
import time
import types

import torch

from portbench import byname, check, inputs, records, stats, tracing
from portbench.reference import pathtracer as pt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracer_tpu")


def load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(bench: dict, w: dict, root: str = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == w["config"]:
            return load_json(os.path.join(root, c["file"]))
    raise KeyError(f"no configuration {w['config']!r} in BENCHMARK.json")


def traffic_of(name: str) -> dict:
    return load_json(os.path.join(HERE, "traffic", f"{name}.json"))


def limits_of(cell: str) -> dict:
    return load_json(os.path.join(HERE, "limits", f"{cell}.json"))


def reader(metric: str):
    """The ``read`` function of ``portbench/metrics/<metric>.py``."""
    return byname.load("metrics", metric).read


def program_knobs(environ=None) -> list:
    """The program's switches (``RAYTPU_*``) set in the environment: a run
    with any measures another path than the cell's and gives no result."""
    environ = os.environ if environ is None else environ
    return sorted(k for k in environ if k.startswith("RAYTPU_"))


def metrics_for(bench: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics (trace off) or per-layer metrics
    (trace on): each listed for it, or listed for no cell in particular
    and moving a metric the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


def forbidden_modules(names=None) -> list:
    """Top-level names among the loaded modules (or ``names``) that the
    run must not load, compared whole: ``raytracer_tpu_torch`` is not
    ``raytracer_tpu``."""
    names = list(sys.modules) if names is None else names
    top = {name.split(".")[0] for name in names}
    return sorted(top & set(FORBIDDEN))


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = (_merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


class _Clock:
    """Set-up split: seconds from the previous mark, by stage."""

    def __init__(self, t_start: float):
        self.t_start = self.t = t_start
        self.split = []

    def mark(self, stage: str) -> float:
        now = time.perf_counter()
        self.split.append((stage, now - self.t))
        self.t = now
        return now


def _soups(win, verts, mats):
    """The window's soup function: its own, or scene 0's alone."""
    if win.scenes is not None:
        return win.scenes

    def scene_zero(i: int):
        if i != 0:
            raise KeyError(f"a call names scene {i}, and the window "
                           f"describes no scenes")
        return verts, mats
    return scene_zero


def _triangles(calls, soups, scene0: int):
    """The triangles a frame of the window traced: scene 0's count when
    every call rendered it, else the mean over the calls of their scene's
    count (each scene's soup made once)."""
    scenes = {c.scene for c in calls}
    if scenes <= {0}:
        return scene0
    counts = {i: len(soups(i)[0]) for i in scenes}
    return sum(counts[c.scene] for c in calls) / len(calls)


def _peaks(kind: str):
    table = load_json(os.path.join(HERE, "peaks.json"))
    for name, p in table.items():
        if name in kind:
            return p
    return None


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             override: dict | None = None, log=None,
             control: bool = False) -> dict:
    """Run the cell once -> the result (the dict printed as the last line
    of standard output). ``override`` merges into the configuration and
    the mix ({"config": {...}, "traffic": {...}}, for tests at a small
    size); ``log`` gets the lines for standard error; ``control`` adds
    the readings of the reference in bfloat16 put in the program's place
    (``control`` key)."""
    t_start = time.perf_counter() if t_start is None else t_start
    say = log if log is not None else (lambda s: print(s, file=sys.stderr))
    clock = _Clock(t_start)
    clock.mark("import torch")
    over = override or {}
    bench = benchmark()
    w = workload(bench, cell)
    config = _merge(config_of(bench, w), over.get("config"))
    traffic = _merge(traffic_of(w["traffic"]), over.get("traffic"))
    limits = limits_of(cell)
    drive = byname.load("drivers", traffic["driver"]).run

    from raytracer_tpu_torch import knobs, native_bridge
    from raytracer_tpu_torch.core.types import CameraUniforms, RenderConfig
    from raytracer_tpu_torch.engine import renderer as renderer_mod
    from raytracer_tpu_torch.kernels import cuda_build, wavefront
    from raytracer_tpu_torch.scene.builder import \
        build_fast_scene_from_arrays
    clock.mark("import program")

    cuda = device == "cuda"
    if cuda:
        torch.cuda.init()
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    clock.mark("cuda init")
    native_bridge.ensure_built()
    if cuda:
        cuda_build.build([knobs.layout()])
    clock.mark("libraries")
    if trace:
        # The profiler's first start loads and sets up its tracer: do it
        # here, not inside the traced window.
        with tracing.Capture(cuda):
            torch.zeros(1, device=device).add_(1)
        clock.mark("profiler")

    cfg = RenderConfig(**config["render"])
    verts, mats = inputs.scene(config, seed)
    scene = build_fast_scene_from_arrays(verts, mats, device=device)
    if cuda:
        torch.cuda.synchronize()
    clock.mark("scene")

    window_s = float(seconds)
    if trace:
        window_s = min(window_s, float(traffic["trace_seconds"]))
    poses = [inputs.camera(config)]
    sky, exposure = bool(config["sky"]), float(config["exposure"])

    def add_pose(uniforms) -> int:
        """Append a pose (as ``inputs.uniforms`` makes it) -> its index."""
        poses.append(uniforms)
        return len(poses) - 1

    def make_uniforms(p: int, fc: int):
        o, llc, hor, ver = poses[p]
        return CameraUniforms.create(o, llc, hor, ver, frame_count=fc,
                                     sky_enabled=sky, exposure=exposure,
                                     device=device)

    chk = traffic["check"]
    distinct_per_frame = 0 if cfg.shading == "fixed_light" else 1

    def judged(frames: int) -> int:
        """Pixels judged whole: about ``paths`` distinct paths over the
        window's frames, within [pixels_min, pixels_max], and never fewer
        than the frames judged alone use."""
        distinct = max(1, frames * distinct_per_frame)
        n = min(int(chk["pixels_max"]), max(int(chk["pixels_min"]),
                int(chk["paths"]) // distinct))
        return max(n, int(chk["frame_pixels"]))

    def pixels(count: int):
        return check.sample_pixels(seed, cfg.width, cfg.height, count)

    spans = None
    marks = {}

    @contextlib.contextmanager
    def window():
        """Around the window: yields ``close``, which the driver calls
        where the window ends; the profiler stops when the block ends, so
        a driver that runs threads stops them in between (the profiler
        must not stop while another thread still runs ops)."""
        marks["start"] = clock.mark("warm-up")
        with contextlib.ExitStack() as stack:
            span = None
            if trace:
                marks["capture"] = stack.enter_context(
                    tracing.Capture(cuda))
                span = torch.profiler.record_function(tracing.WINDOW_SPAN)
                span.__enter__()
                spans.reset()

            def close():
                nonlocal span
                if span is not None:
                    marks["spans"] = spans.snapshot()
                    span.__exit__(None, None, None)
                    span = None

            try:
                yield close
            finally:
                close()

    if trace:
        spans = tracing.Spans()
        spans.wrap(wavefront, "wavefront_bounces", "wavefront")
        spans.wrap(renderer_mod, "wavefront_tail", "wavefront")
    env = records.Env(Renderer=renderer_mod.Renderer, cfg=cfg, scene=scene,
                      traffic=traffic, make_uniforms=make_uniforms,
                      device=device, seed=seed, seconds=window_s,
                      pixels=pixels, judged=judged, window=window,
                      config=config, soup=(verts, mats), add_pose=add_pose,
                      spans=spans)
    try:
        win = drive(env)
    finally:
        if spans is not None:
            spans.restore()
    setup_s = marks["start"] - t_start
    capture = marks.get("capture")

    calls = win.calls
    soups = _soups(win, verts, mats)
    n_window = len(calls)
    rays = (int(torch.stack([torch.as_tensor(c.rays).reshape(())
                             for c in calls]).sum()) if calls else 0)
    primaries = sum(c.size[0] * c.size[1] for c in calls)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    # The program's state goes before the reference runs on the card.
    del env, scene
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # --- the check ---------------------------------------------------------
    full = (cfg.width, cfg.height)
    xs, ys = pixels(judged(n_window))
    shading = pt.Shading(
        max_bounces=cfg.max_bounces, t_min=cfg.t_min, t_max=cfg.t_max,
        fuzz=cfg.fuzz, det_eps=cfg.det_eps,
        samples_per_pixel=cfg.samples_per_pixel,
        emissive_emits=cfg.emissive_emits,
        fixed_light=cfg.shading == "fixed_light", sky=sky,
        exposure=exposure)
    t_ref = time.perf_counter()
    ks = check.wanted(calls, win.seen, win.snaps)
    ref = check.Judge(soups, poses, shading, full, (xs, ys), device)
    ref_out = ref.outputs(calls, ks)
    values = check.numbers(calls, win.seen, win.snaps, ref_out)
    correct, rows = check.verdict(values, limits)
    ref_s = time.perf_counter() - t_ref
    result_control = None
    if control:
        low = check.Judge(soups, poses, shading, full, (xs, ys), device,
                          dtype=torch.bfloat16)
        seen, snaps = check.as_program(calls, win.seen, win.snaps,
                                       low.outputs(calls, ks))
        cvals = check.numbers(calls, seen, snaps, ref_out)
        result_control = check.verdict(cvals, limits)[1]

    # --- metrics -----------------------------------------------------------
    metrics = {}
    wanted = metrics_for(bench, cell, trace)
    arrived = [a for a in win.arrivals if a <= window_s]
    if not trace:
        gaps_ms = [x * 1e3 for x in stats.intervals_between(arrived, 0.0)]
        values_e2e = {"setup_s": setup_s}
        if arrived:
            values_e2e["frame_ms"] = stats.frame_ms(window_s * 1e3,
                                                    [a * 1e3 for a in arrived])
            values_e2e["frame_ms_p95"] = stats.percentile(gaps_ms, 95)
        for m in wanted:
            if m["name"] in values_e2e:
                metrics[m["name"]] = {"value": values_e2e[m["name"]],
                                      "unit": m["unit"]}
        say(f"frame_ms_p95 over {len(gaps_ms)} intervals; {len(arrived)} "
            f"frames arrived, {n_window} rendered, "
            f"{rays / max(1, n_window):.1f} rays traced a frame")
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": int(w["chips"]), "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        tr = tracing.Trace(capture.prof) if capture is not None else None
        ctx = types.SimpleNamespace(
            trace=tr, spans=marks.get("spans", {}),
            syncs=capture.syncs if capture else None,
            frames=n_window, window_s=tr.window_s if tr else window_s,
            primaries=primaries, rays=rays,
            triangles=_triangles(calls, soups, int(len(verts))),
            peaks=_peaks(kind))
        for m in wanted:
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if tr is not None:
            say(f"trace: {len(tr.names)} events by kind "
                f"{ {k: int(v) for k, v in tr.kinds.items()} }; "
                f"{ctx.syncs} syncs; spans {ctx.spans}")
            device_info["busy_s"] = tr.busy_s()
            device_info["window_s"] = tr.window_s
            breakdown = {"device_ops": tr.top_ops(),
                         "idle_gaps": tr.idle_gaps()}

    split = ", ".join(f"{k} {v:.3f} s" for k, v in clock.split)
    say(f"setup_s {setup_s:.3f}: {split}")
    say(f"reference {ref_s:.3f} s: {len(win.seen)} outputs x {len(xs)} "
        f"pixels, {len(win.snaps)} frames alone x "
        f"{len(win.snaps[0].after) if win.snaps else 0} pixels; "
        f"failed {win.failed}")
    if result_control is not None:
        say("control (bfloat16 reference): " + "; ".join(
            f"{n} {v} (limit {lim})" for n, v, lim in result_control))
    result = {"correct": bool(correct),
              "attempted": n_window, "failed": int(win.failed),
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if result_control is not None:
        result["control"] = {n: v for n, v, _ in result_control}
    result["check"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    for n, v, lim in rows:
        say(f"check {n} {v} limit {lim}")
    return result
