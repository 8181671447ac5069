"""``renderer``: the closed loop of a headless render. Frames run back
to back through ``Renderer.render`` with a still camera, the frame
counter rising and the accumulator carried. A CUDA event recorded after
each frame stamps its arrival; nothing waits for the card inside the
window.

The check's outputs: the window's last frame (u8 image and accumulator)
at the judged pixels, and the frames found at ``check.frames`` times
drawn from the seed across the window, each by the accumulator at the
first ``check.frame_pixels`` pixels just before and just after its
render call, gathered on the card with no wait."""

import time

import numpy as np
import torch

from portbench.records import Call, Seen, Snap, Window


def _gather(acc, flat):
    return acc.reshape(-1, 3).index_select(0, flat)


def run(env) -> Window:
    cfg, dev, chk = env.cfg, env.device, env.traffic["check"]
    cuda = dev == "cuda"
    size = (cfg.width, cfg.height)
    r = env.Renderer(cfg)
    acc = None
    for f in range(int(env.traffic["warm_frames"])):
        acc, _, _ = r.render(env.scene, env.make_uniforms(0, f), acc)
    if cuda:
        torch.cuda.synchronize()
    acc = None
    xs, ys = env.pixels(int(chk["frame_pixels"]))
    flat = torch.as_tensor(ys * cfg.width + xs, device=dev)
    due = np.sort(np.random.default_rng([env.seed, 0x5A]).uniform(
        0.0, env.seconds, int(chk["frames"])))
    calls, marks, snaps = [], [], []
    nxt, fc = 0, 0
    with env.window() as close:
        start = torch.cuda.Event(enable_timing=True) if cuda else None
        t0 = time.perf_counter()
        if cuda:
            start.record()
        while True:
            t = time.perf_counter() - t0
            if t >= env.seconds:
                break
            snap = nxt < len(due) and due[nxt] <= t
            if snap:
                while nxt < len(due) and due[nxt] <= t:
                    nxt += 1
                before = None if acc is None else _gather(acc, flat)
            calls.append(Call(size, 0, fc, t))
            acc, image, stats = r.render(env.scene,
                                         env.make_uniforms(0, fc), acc)
            calls[-1].rays = stats["rays_traced"]
            if snap:
                snaps.append((len(calls) - 1, before, _gather(acc, flat)))
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append(ev)
            else:
                marks.append(time.perf_counter() - t0)
            fc += 1
        if cuda:
            torch.cuda.synchronize()
        close()
    arrivals = ([start.elapsed_time(e) / 1e3 for e in marks] if cuda
                else marks)
    xs, ys = env.pixels(env.judged(len(calls)))
    flat = torch.as_tensor(ys * cfg.width + xs, device=dev)
    seen = Seen(len(calls) - 1, _gather(image, flat).cpu().numpy(),
                _gather(acc, flat).cpu().numpy())
    snaps = [Snap(k, None if b is None else b.cpu().numpy(),
                  a.cpu().numpy()) for k, b, a in snaps]
    return Window(arrivals, calls, 0, [seen], snaps)
