"""Device time of the walking kernels at the main path's shapes, for one or
more checkouts of the repo, in turns on one card.

    python kernel_times.py [--trees DIR ...] [--turns 2] [--reps 20]
                           [--bcaps 2,3,5] [--rows ROW,...]

Each checkout (a directory holding ``raytracer_tpu_torch/`` and
``native/``; default: this one) runs in a child process of its own that
builds that checkout's kernels and imports its package. On the flagship
scene at ``RenderConfig()`` it times, with CUDA events (mean of ``--reps``
launches after one warm-up): kernel A (``trace4``) and ``trace2`` on the
307,200 primaries of the middle 720p band (``trace2`` as the bounce-0
call launches it: its warp design where the checkout has one), ``trace2``
also on the split engine's sorted bounce-1 round of that band
(``trace2_split``), kernel B (``bounce12``) on the band's sorted bounce-1
state (``chip_smoke.py`` phase 3's shapes), ``bounce15`` as the pmega
call (bcap 9) on the middle band's state and on the top and bottom
bands' (``bounce15_top``, ``bounce15_bottom``; with ``--bcaps``, also at
those bcaps on the middle band, rows ``bounce15_b<k>``) and as a fused
round (bcap 1), ``bounce_packed`` on the ``fused_packed`` round's state
of the middle band and of the top and bottom bands
(``bounce_packed_top``, ``bounce_packed_bottom``),
``bounce12_pl`` (kernel B with the walk's postponed leaves, where the
checkout has it), kernel B's key and walk-order builds where the checkout
has them (``chip_smoke.KEY_BUILDS``: ``bounce12_pd5``, ``bounce12_om9``,
``bounce12_unordered``, ``bounce15_pd5``, ``bounce15_om9``,
``bounce15_unordered``, ``bounce_packed_pd5``, ``bounce_packed_om9``, each
on the middle band's bounce-1 state sorted by its key, as
``chip_smoke.py`` phase 20 runs them), and the tonemap on a 1280x720
frame at spp 1: its kernel's device time from the profiler, after an L2
flush (``tonemap``) and with its inputs in L2 (``tonemap_warm``), and
the time of a call (``tonemap_call``), and the ``mega`` kernel on a
band's whole call: from bounce 0 on the middle band's raster primaries
(``mega``, ``RAYTPU_B0=mega``'s state), from bounce 1 on its state after
kernel A (``mega_b1``) and from bounce 0 on the top and bottom bands
(``mega_top``, ``mega_bottom``), each its kernel's device time from the
profiler and a call's time (``call_ms``), checked against the plain
version once a checkout (a plain call takes seconds; its result is kept
for the later turns), with the lane occupancy of one ray a thread at
walk level and, where the checkout has the counting build, the visit
and leaf SIMD efficiency of both schedules (``mega_lanes``), and the
720p frames of ``RAYTPU_B0=mega`` and ``RAYTPU_BOUNCE=mega``
(``frame_b0_mega``, ``frame_bounce_mega``: wall and device busy ms a
frame, idle share, device activities and ``mega``'s ms a frame), and,
where the checkout has them, the ray-gen and shade kernels on the middle
band (``raygen``, ``shade``: ``chip_smoke.check_front``, device ms from
device memory, ``warm_ms`` from L2, ``call_ms``, ``plain_ms`` and the
bytes bound); with each pmega state's lane
occupancy (``chip_smoke.lane_occupancy``) and, where the checkout has the
packed kernel's counting build, each packed round's walk efficiency
(``chip_smoke.packed_round_profile``). The inputs come from this
checkout's ``chip_smoke.py`` helpers, run against each checkout's
package. Each kernel's output is compared with its plain version on the
same inputs (differing lanes are printed). Per kernel it also prints
registers, local memory bytes, shared bytes and resident blocks per SM
from the checkout's ``cuda_build.kernel_attrs`` (null where the checkout
has none). ``--rows`` times only the rows named. Checkouts run in turns
(A B C, C B A, ...), so drift of the card's clocks shows as a difference
between turns. One JSON line per checkout and turn, then one summary
line. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))
# The mega rows: the band (None: the middle one) and the bounce the state
# starts from (chip_smoke.band_raster from 0, band_bounce1 from 1).
MEGA_ROWS = {"mega": (None, 0), "mega_b1": (None, 1), "mega_top": (0, 0),
             "mega_bottom": (2, 0)}
# Whole frames of the paths that launch mega (row -> their knobs).
FRAME_ROWS = {"frame_b0_mega": {"RAYTPU_B0": "mega"},
              "frame_bounce_mega": {"RAYTPU_BOUNCE": "mega"}}
KERNELS = ("trace4", "bounce12", "bounce12_pl", "bounce15", "bounce15_top",
           "bounce15_bottom", "bounce15_fused", "bounce_packed",
           "bounce_packed_top", "bounce_packed_bottom", "trace2",
           "trace2_split", "tonemap", "tonemap_warm", "tonemap_call",
           "bounce12_pd5", "bounce12_om9", "bounce12_unordered",
           "bounce15_pd5", "bounce15_om9", "bounce15_unordered",
           "bounce_packed_pd5", "bounce_packed_om9", *MEGA_ROWS,
           *FRAME_ROWS, "raygen", "shade")
# Row -> the kernel whose attributes it reports, where the checkout's
# cuda_build knows that kernel (else the row's name, or bounce15 for the
# pmega rows).
ATTRS_OF = {"trace2": "trace2_warp", "trace2_split": "trace2",
            "bounce15": "bounce15_pmega", "bounce15_top": "bounce15_pmega",
            "bounce15_bottom": "bounce15_pmega",
            "bounce15_fused": "bounce15", "bounce_packed_top": "bounce_packed",
            "bounce_packed_bottom": "bounce_packed", "tonemap_warm": "tonemap",
            "tonemap_call": "tonemap", **{k: "mega" for k in MEGA_ROWS}}
ATTRS = ("regs", "local_bytes", "smem_bytes", "blocks_per_sm", "threads")


def run_one(tree: str, reps: int, bcaps=(), rows=None,
            plain_dir=None) -> dict:
    """Time and check the kernels of one checkout (in this process);
    ``plain_dir`` keeps the ``mega`` rows' plain results between turns."""
    import functools
    import inspect

    import torch

    import chip_smoke as cs     # this checkout's; imports no package
    sys.path.insert(0, tree)
    from raytracer_tpu_torch.core.camera import default_camera
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.kernels import bounce, cuda_build, tonemap
    from raytracer_tpu_torch.kernels import trace, wavefront
    from raytracer_tpu_torch.scene import presets

    pkg = os.path.dirname(os.path.dirname(cuda_build.__file__))
    assert os.path.dirname(pkg) == os.path.abspath(tree), pkg
    cuda_build.library()
    cfg = RenderConfig()
    scene = presets.flagship_scene()
    cam = default_camera(cfg.width, cfg.height).uniforms()
    cache = functools.cache

    # Each row's inputs, made when a row that runs needs them.
    @cache
    def primaries():
        _, _, ray_o, ray_d, alive, _ = cs.band_primaries(scene, cfg, cam)
        return torch.stack([*ray_o, *ray_d]).contiguous(), alive

    @cache
    def bounce1():
        return cs.band_bounce1(scene, cfg, cam)

    @cache
    def st12():
        o, d, color, atten, seed, alive1, pix = bounce1()
        att12 = tuple(torch.where(alive1, a, c)
                      for a, c in zip(atten, color))
        st = bounce.pack_state(o, d, att12, seed, alive1,
                               bounce.UNIFORM_BUDGET, pix)
        return wavefront._sorted(st, wavefront._state_key(st, scene))[0]

    @cache
    def fused():
        o, d, color, atten, seed, alive1, pix = bounce1()
        flat = bounce.pack_state(o, d, atten, seed, alive1,
                                 bounce.UNIFORM_BUDGET, pix, color=color)
        return wavefront._sorted(flat, wavefront._state_key(flat, scene))[0]

    pmega = cache(lambda band=None: cs.pmega_state(scene, cfg, cam, band))
    packed = cache(lambda band=None: cs.packed_state(scene, cfg, cam, band))
    split = cache(lambda: cs.split_round1(scene, cfg, cam))
    b0 = ({"coherent": True}
          if "coherent" in inspect.signature(trace.trace2).parameters
          else {})
    nb = cfg.max_bounces - 1
    calls = {
        "trace4": (lambda: trace.trace4(scene, *primaries(), cfg),
                   lambda: trace.trace4_plain(scene, *primaries(), cfg)),
        "bounce12": (lambda: bounce.bounce12(scene, st12(), 1, True, cfg),
                     lambda: bounce.bounce12_plain(scene, st12(), 1, True,
                                                   cfg)),
        "bounce15_fused": (
            lambda: bounce.bounce15(scene, fused(), 1, True, cfg),
            lambda: bounce.bounce15_plain(scene, fused(), 1, True, cfg)),
        "trace2": (lambda: trace.trace2(scene, *primaries(), cfg, **b0),
                   lambda: trace.trace2_plain(scene, *primaries(), cfg)),
        "trace2_split": (
            lambda: trace.trace2(scene, *split(), cfg),
            lambda: trace.trace2_plain(scene, *split(), cfg)),
    }
    for suffix, band in (("", None), ("_top", 0), ("_bottom", 2)):
        calls[f"bounce15{suffix}"] = (
            lambda band=band: bounce.bounce15(scene, pmega(band), nb, True,
                                              cfg),
            lambda band=band: bounce.bounce15_plain(scene, pmega(band), nb,
                                                    True, cfg))
        calls[f"bounce_packed{suffix}"] = (
            lambda band=band: bounce.bounce_packed(scene, *packed(band), 1,
                                                   True, cfg),
            lambda band=band: bounce.bounce_packed_plain(
                scene, *packed(band), 1, True, cfg))
    if "bounce12_pl" in cuda_build.KERNELS:
        calls["bounce12_pl"] = (
            lambda: bounce._launch_rounds("bounce12_pl", scene, st12(), 1,
                                          True, cfg),
            lambda: bounce.bounce12_plain(scene, st12(), 1, True, cfg))
    if "bounce12_pd5" in cuda_build.KERNELS and (
            not rows or any(k in cs.KEY_BUILDS for k in rows)):
        states = {m: cs.key_states(scene, cfg, cam, m)
                  for m in ("cid", "pd5", "om9")}
        for name, (kernel, key_mode, *_) in cs.KEY_BUILDS.items():
            st, st15, packed_st = states[key_mode]
            state = {"bounce12": st, "bounce15": st15}.get(kernel,
                                                           packed_st)
            calls[name] = cs.build_calls(scene, cfg, name, state)
    if rows:
        calls = {k: v for k, v in calls.items() if k in rows}
    attrs_of = dict(ATTRS_OF)
    for k in bcaps:
        calls[f"bounce15_b{k}"] = (
            lambda k=k: bounce.bounce15(scene, pmega(), k, True, cfg),
            lambda k=k: bounce.bounce15_plain(scene, pmega(), k, True, cfg))
        attrs_of[f"bounce15_b{k}"] = ("bounce15_pmega" if k > 1
                                      else "bounce15")
    occupancy = {}
    packed_walk = {}
    ins = {"bounce15": None, "bounce15_top": 0, "bounce15_bottom": 2}
    res = {}
    for name, (kern, plain) in calls.items():
        got, want = kern(), plain()
        if name in ins:
            occupancy[name] = cs.lane_occupancy(pmega(ins[name]), want[0])
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        lanes = torch.zeros(got[0].shape[-1], dtype=torch.bool,
                            device="cuda")
        for g, w in zip(got, want):
            g, w = (x.view(torch.int32) if x.dtype == torch.float32 else x
                    for x in (g, w))
            if g.shape[-1] == lanes.shape[0]:
                lanes |= (g != w).reshape(-1, lanes.shape[0]).any(0)
            elif not torch.equal(g, w):
                lanes[:] = True
        res[name] = dict(ms=cs.time_ms(kern, reps),
                         differing_lanes=int(lanes.sum()))
        bands = {"bounce_packed": None, "bounce_packed_top": 0,
                 "bounce_packed_bottom": 2}
        if name in bands and hasattr(bounce, "bounce_packed_count"):
            packed_walk[name] = cs.packed_round_profile(
                scene, *packed(bands[name]), cfg, got)
    front_rows(scene, cfg, cam, rows, res)
    mega_lanes = mega_rows(scene, cfg, cam, reps, rows, plain_dir, res)
    for name, env in FRAME_ROWS.items():
        if not rows or name in rows:
            res[name] = frame_row(scene, cfg, env)
    if not rows or "tonemap" in rows:
        res.update(tonemap_rows(tonemap, reps))
    for name in res:
        of = attrs_of.get(name, name)
        if of not in getattr(cuda_build, "KERNELS", ()) and name in calls:
            of = name.split("_")[0] if name.startswith("bounce15") else name
        attrs = (cuda_build.kernel_attrs(of)
                 if of in getattr(cuda_build, "KERNELS", ()) else {})
        res[name].update({a: attrs.get(a) for a in ATTRS})
    return dict(tree=tree, device=torch.cuda.get_device_name(0),
                pmega_lanes=occupancy, packed_walk=packed_walk,
                mega_lanes=mega_lanes, kernels=res)


def mega_rows(scene, cfg, cam, reps: int, rows, plain_dir, res) -> dict:
    """The ``mega`` rows (``MEGA_ROWS``) that run: the kernel's device
    time (profiler) and a call's time into ``res``, with the differing
    colour pixels and rays traced against the plain version, whose
    results (and walks a ray) are computed once a checkout and kept in
    ``plain_dir`` for its later turns. -> each row's lane occupancy of one
    ray a thread at walk level (``chip_smoke.walk_occupancy``) and, where
    the checkout has the counting build, its visit and leaf SIMD
    efficiency under both schedules (``chip_smoke.mega_profile``)."""
    import torch

    import chip_smoke as cs
    from raytracer_tpu_torch.engine.renderer import _num_bands
    from raytracer_tpu_torch.kernels import mega
    from raytracer_tpu_torch.kernels.packet import megakernel_bounces

    n_out = cfg.height // _num_bands(cfg) * cfg.width
    lanes = {}
    for name, (band, start) in MEGA_ROWS.items():
        if rows and name not in rows:
            continue
        state = (cs.band_raster if start == 0 else cs.band_bounce1)(
            scene, cfg, cam, band)
        args = (scene, *state[:6], True, cfg, start, state[6], n_out)
        got, rays = mega.mega(*args)
        path = plain_dir and os.path.join(plain_dir, f"{name}.pt")
        if path and os.path.exists(path):
            want, want_rays, walks = torch.load(path)
        else:
            want, want_rays, walks = (
                t.cpu() for t in megakernel_bounces(*args, walks=True))
            if path:
                torch.save((want, want_rays, walks), path)
        diff = (got.view(torch.int32).cpu() != want.view(torch.int32)).any(0)
        res[name] = dict(ms=cs.device_ms(lambda: mega.mega(*args), reps,
                                         "mega_kernel"),
                         call_ms=cs.time_ms(lambda: mega.mega(*args), reps),
                         differing_lanes=int(diff.sum())
                         + int(int(rays) != int(want_rays)))
        lanes[name] = dict(walk=cs.walk_occupancy(walks),
                           visit=(cs.mega_profile(args, got, rays)
                                  if hasattr(mega, "mega_count") else None))
    return lanes


def front_rows(scene, cfg, cam, rows, res) -> None:
    """The ``raygen`` and ``shade`` rows, where the checkout has those
    kernels (``packet.primary_rays``): ``chip_smoke.check_front`` on the
    middle band (0 differing bytes required; device ms from device memory
    and from L2, call ms, plain ms, bound) into ``res``."""
    from raytracer_tpu_torch.kernels import packet

    import chip_smoke as cs

    if not hasattr(packet, "primary_rays") or (
            rows and not {"raygen", "shade"} & set(rows)):
        return
    out = {}
    cs.check_front(scene, cfg, cam, out)
    res.update({k: dict(v, differing_lanes=v["differing_bytes"])
                for k, v in out.items() if not rows or k in rows})


def frame_row(scene, cfg, env: dict, frames: int = 4) -> dict:
    """A 720p path's frames under the knobs ``env`` (one warm frame, then
    ``frames`` profiled, ``apps/profile.py``): wall ms a frame, device
    busy ms and idle share, device activities a frame and the ``mega``
    kernel's ms a frame."""
    from raytracer_tpu_torch.apps.profile import profile_path

    st = profile_path(scene, cfg, env, frames, 1)
    return dict(ms=st["wall_ms_per_frame"],
                device_busy_ms=st["device_busy_ms_per_frame"],
                device_idle_share=st["device_idle_share"],
                device_launches=st["device_launches_per_frame"],
                mega_ms=sum(t for n, t in
                            st["port_kernels_ms_per_frame"].items()
                            if "mega_kernel" in n),
                differing_lanes=None)


def tonemap_rows(tonemap, reps: int) -> dict:
    """The tonemap on a 1280x720 frame at spp 1 (the checkout's: the band
    sum f32[3, H*W] and spp, or, before it took them, the [H, W, 3]
    sample): the kernel's device time and a call's time; the bytes that
    differ from the plain version."""
    import inspect

    import torch

    import chip_smoke as cs

    g = torch.Generator(device="cuda").manual_seed(11)
    h, w = 720, 1280
    accum = torch.rand((h, w, 3), generator=g, device="cuda") * 1.5
    total = torch.rand((3, h * w), generator=g, device="cuda") * 3.0
    fc = torch.tensor(5, dtype=torch.int32, device="cuda")
    ex = torch.tensor(0.5, device="cuda")
    if len(inspect.signature(tonemap.tonemap_plain).parameters) == 5:
        args = (total, 1, fc, ex)
    else:
        args = (total.T.reshape(h, w, 3).contiguous(), fc, ex)
    acc_k, img_k = tonemap.tonemap_accumulate(accum.clone(), *args)
    acc_p, img_p = tonemap.tonemap_plain(accum.clone(), *args)
    diff = int((acc_k.view(torch.int32) != acc_p.view(torch.int32)).sum()
               + (img_k != img_p).sum())
    scratch = accum.clone()

    def call():
        return tonemap.tonemap_accumulate(scratch, *args)

    return {"tonemap": dict(ms=cs.device_ms(call, reps, "tonemap",
                                            cold=True),
                            differing_lanes=diff),
            "tonemap_warm": dict(ms=cs.device_ms(call, reps, "tonemap"),
                                 differing_lanes=diff),
            "tonemap_call": dict(ms=cs.time_ms(call, reps),
                                 differing_lanes=diff)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--trees", nargs="*", default=[REPO])
    p.add_argument("--turns", type=int, default=2)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--bcaps", default="",
                   help="comma-separated extra bcaps for bounce15")
    p.add_argument("--rows", default="",
                   help="comma-separated rows to time (default all; "
                        "tonemap times its three rows)")
    p.add_argument("--one", help=argparse.SUPPRESS)
    p.add_argument("--plain-dir", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    bcaps = [int(k) for k in args.bcaps.split(",") if k]
    rows = [k for k in args.rows.split(",") if k]
    if args.one:
        print(json.dumps(run_one(os.path.abspath(args.one), args.reps,
                                 bcaps, rows, args.plain_dir)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    trees = [os.path.abspath(t) for t in args.trees]
    runs = {t: [] for t in trees}
    failed = False
    # The mega rows' plain results, one directory a checkout.
    plain = tempfile.mkdtemp(prefix="kernel_times_")
    for turn in range(args.turns):
        for tree in trees if turn % 2 == 0 else trees[::-1]:
            plain_dir = os.path.join(plain, str(trees.index(tree)))
            os.makedirs(plain_dir, exist_ok=True)
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", tree,
                 "--reps", str(args.reps), "--bcaps", args.bcaps,
                 "--rows", args.rows, "--plain-dir", plain_dir],
                capture_output=True, text=True)
            if out.returncode:
                print(f"{tree} failed ({out.returncode}):\n"
                      f"{out.stdout[-3000:]}{out.stderr[-3000:]}",
                      flush=True)
                failed = True
                continue
            res = json.loads(out.stdout.strip().splitlines()[-1])
            res["turn"] = turn
            print(json.dumps(res), flush=True)
            runs[tree].append(res)
    shutil.rmtree(plain)
    names = [k for k in KERNELS if not rows or k in rows
             or k.startswith("tonemap") and "tonemap" in rows]
    names += [f"bounce15_b{k}" for k in bcaps]
    summary = {t: {k: [r["kernels"][k]["ms"] for r in rs
                       if k in r["kernels"]] for k in names}
               for t, rs in runs.items()}
    print(json.dumps({"device": smi, "ms_by_turn": summary}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
