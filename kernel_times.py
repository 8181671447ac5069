"""Device time of the walking kernels at the main path's shapes, for one or
more checkouts of the repo, in turns on one card.

    python kernel_times.py [--trees DIR ...] [--turns 2] [--reps 20]

Each checkout (a directory holding ``raytracer_tpu_torch/`` and
``native/``; default: this one) runs in a child process of its own that
builds that checkout's kernels and imports its package. On the flagship
scene at ``RenderConfig()`` it times, with CUDA events (mean of ``--reps``
launches after one warm-up): kernel A (``trace4``) and ``trace2`` on the
307,200 primaries of the middle 720p band, kernel B (``bounce12``) on that
band's sorted bounce-1 state (``chip_smoke.py`` phase 3's shapes),
``bounce15`` as the pmega call (bcap 9) and as a fused round (bcap 1), and
``bounce_packed``. The inputs come from this checkout's
``chip_smoke.py`` helpers, run against each checkout's package. Each
kernel's output is compared with its plain version on the same inputs
(differing lanes are printed). Per kernel it also prints registers, local
memory bytes, shared bytes and resident blocks per SM from the
checkout's ``cuda_build.kernel_attrs`` (null where the checkout has
none). Checkouts run in turns (A B C, C B A, ...), so drift of the card's
clocks shows as a difference between turns. One JSON line per checkout
and turn, then one summary line. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
KERNELS = ("trace4", "bounce12", "bounce15", "bounce15_fused",
           "bounce_packed", "trace2")
ATTRS = ("regs", "local_bytes", "smem_bytes", "blocks_per_sm", "threads")


def run_one(tree: str, reps: int) -> dict:
    """Time and check the kernels of one checkout (in this process)."""
    import torch

    import chip_smoke as cs     # this checkout's; imports no package
    sys.path.insert(0, tree)
    from raytracer_tpu_torch.core.camera import default_camera
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.kernels import bounce, cuda_build, trace
    from raytracer_tpu_torch.kernels import wavefront
    from raytracer_tpu_torch.scene import presets

    pkg = os.path.dirname(os.path.dirname(cuda_build.__file__))
    assert os.path.dirname(pkg) == os.path.abspath(tree), pkg
    cuda_build.library()
    cfg = RenderConfig()
    scene = presets.flagship_scene()
    cam = default_camera(cfg.width, cfg.height).uniforms()
    _, _, ray_o, ray_d, alive, _ = cs.band_primaries(scene, cfg, cam)
    rays = torch.stack([*ray_o, *ray_d]).contiguous()
    o, d, color, atten, seed, alive1, pix = cs.band_bounce1(scene, cfg, cam)
    att12 = tuple(torch.where(alive1, a, c) for a, c in zip(atten, color))
    st12 = bounce.pack_state(o, d, att12, seed, alive1,
                             bounce.UNIFORM_BUDGET, pix)
    st12, _ = wavefront._sorted(st12, wavefront._state_key(st12, scene))
    flat = bounce.pack_state(o, d, atten, seed, alive1,
                             bounce.UNIFORM_BUDGET, pix, color=color)
    fused, _ = wavefront._sorted(flat, wavefront._state_key(flat, scene))
    smin, smax = scene.bounds()
    order = torch.argsort(wavefront.sort_key(o, d, alive1, smin, smax),
                          stable=True)
    pmega = flat.index_select(1, order)
    sf = torch.stack([*o, *d, *color, *atten, alive1.to(torch.float32)])
    si = torch.stack([seed.to(torch.int32), pix])
    (sf, si), _ = wavefront._sorted((sf, si),
                                    wavefront._state_key((sf, si), scene))
    nb = cfg.max_bounces - 1
    calls = {
        "trace4": (lambda: trace.trace4(scene, rays, alive, cfg),
                   lambda: trace.trace4_plain(scene, rays, alive, cfg)),
        "bounce12": (lambda: bounce.bounce12(scene, st12, 1, True, cfg),
                     lambda: bounce.bounce12_plain(scene, st12, 1, True,
                                                   cfg)),
        "bounce15": (lambda: bounce.bounce15(scene, pmega, nb, True, cfg),
                     lambda: bounce.bounce15_plain(scene, pmega, nb, True,
                                                   cfg)),
        "bounce15_fused": (
            lambda: bounce.bounce15(scene, fused, 1, True, cfg),
            lambda: bounce.bounce15_plain(scene, fused, 1, True, cfg)),
        "bounce_packed": (
            lambda: bounce.bounce_packed(scene, sf, si, 1, True, cfg),
            lambda: bounce.bounce_packed_plain(scene, sf, si, 1, True, cfg)),
        "trace2": (lambda: trace.trace2(scene, rays, alive, cfg),
                   lambda: trace.trace2_plain(scene, rays, alive, cfg)),
    }
    res = {}
    for name, (kern, plain) in calls.items():
        got, want = kern(), plain()
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
    for name in KERNELS:
        attrs = (cuda_build.kernel_attrs(name.split("_fused")[0])
                 if hasattr(cuda_build, "kernel_attrs") else {})
        res[name].update({a: attrs.get(a) for a in ATTRS})
    return dict(tree=tree, device=torch.cuda.get_device_name(0),
                kernels=res)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--trees", nargs="*", default=[REPO])
    p.add_argument("--turns", type=int, default=2)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--one", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.one:
        print(json.dumps(run_one(os.path.abspath(args.one), args.reps)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    trees = [os.path.abspath(t) for t in args.trees]
    runs = {t: [] for t in trees}
    failed = False
    for turn in range(args.turns):
        for tree in trees if turn % 2 == 0 else trees[::-1]:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", tree,
                 "--reps", str(args.reps)], capture_output=True, text=True)
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
    summary = {t: {k: [r["kernels"][k]["ms"] for r in rs] for k in KERNELS}
               for t, rs in runs.items()}
    print(json.dumps({"device": smi, "ms_by_turn": summary}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
