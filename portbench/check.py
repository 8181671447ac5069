"""How ``correct`` is decided: the outputs the window itself produced,
judged against the plain reference (``portbench/reference``).

The driver hands back two kinds of output, at pixels drawn from the seed
(``sample_pixels``; every count is a prefix of one order, so the frames
judged alone use the first pixels of the set judged whole):

* ``Seen``: an output judged whole, the u8 image and the f32 accumulator
  after one render call;
* ``Snap``: a frame judged alone, the accumulator just before and just
  after its render call.

An output's history is the run of calls of its frame size back to the
last one at frame counter 0, which overwrites the accumulator. Each call
names the camera pose and the scene it rendered (``Call.pose``,
``Call.scene``), so a history may cross a move or an edit: it is replayed
as the program accumulated it, each frame against its own pose and scene.
The reference traces every (pose, scene, frame counter) of the histories
at those pixels, replays the running average over them and tonemaps. The
window stores no soups: the Judge asks the driver's soup function
(``Window.scenes``) for each scene the histories reach, makes its
triangles when their turn comes and frees them before the next, so a
window of thousands of edits costs only the judged histories' scenes.
The numbers compared:

* ``accum_mae``: mean |accumulator - reference| (linear radiance);
* ``image_mae``: mean |u8 - reference u8| (levels);
* ``frame_mae``: the largest, over the frames judged alone, of the mean
  |(fc + 1) (after - ref after) - fc (before - ref before)|: the frame's
  own radiance against the reference's, as the accumulators give it
  (acc = (acc fc + s) / (fc + 1)). A frame gone wrong moves the running
  average of a long window by its share alone; this number reads it
  whole.

A cell compares the numbers its limits file (``portbench/limits/<cell>.
json``) names, each against its own limit. Paths that rounding sends
another way (a grazing hit, a draw at the edge of the unit ball) differ
by a whole path's radiance, so the numbers are means and never zero.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.records import Seen, Snap
from portbench.reference import pathtracer as pt


def sample_pixels(seed: int, width: int, height: int, count: int):
    """The first ``count`` pixels of a width x height frame in an order
    drawn from the seed -> (xs, ys) int64 arrays."""
    order = np.random.default_rng([int(seed), 0x9B]).permutation(
        width * height)[:min(int(count), width * height)]
    return (order % width).astype(np.int64), (order // width).astype(
        np.int64)


def history(calls, k: int):
    """Indices of the calls whose frames the accumulator of call k holds:
    back over calls of its frame size to the last at frame counter 0
    (inclusive), or None when the log does not reach one."""
    size = calls[k].size
    out = []
    for j in range(k, -1, -1):
        if calls[j].size != size:
            continue
        out.append(j)
        if calls[j].fc == 0:
            return out[::-1]
    return None


def before(calls, k: int):
    """The call whose accumulator call k starts from, or None at frame
    counter 0."""
    h = history(calls, k)
    return h[-2] if len(h) > 1 else None


def wanted(calls, seen, snaps) -> set:
    """The calls whose accumulators the numbers need."""
    out = {s.call for s in seen}
    for s in snaps:
        out.add(s.call)
        if before(calls, s.call) is not None:
            out.add(before(calls, s.call))
    return out


class Judge:
    """The reference's view of one run: the scenes, the poses, the frame
    settings and the judged pixels, in one precision. ``soups`` maps a
    call's scene index to its (verts, mats)."""

    def __init__(self, soups, poses, shading: pt.Shading,
                 full_size: tuple, pixels, device, dtype=torch.float32,
                 max_paths: int = 131072):
        self.soups = soups
        self.poses = poses
        self.sh = shading
        self.full = full_size
        self.xs, self.ys = pixels
        self.device = torch.device(device)
        self.dtype = dtype
        self.max_paths = max_paths

    def _coords(self, size):
        fx, fy = self.full[0] // size[0], self.full[1] // size[1]
        return (torch.as_tensor(self.xs // fx, device=self.device),
                torch.as_tensor(self.ys // fy, device=self.device))

    def _fc(self, call) -> int:
        return 0 if self.sh.fixed_light else call.fc

    def _frames(self, calls, idx):
        """{(size, pose, scene, fc): the frame's radiance at the pixels}
        for the calls ``idx``, a scene at a time (its triangles made, its
        frames traced in chunks of at most ``max_paths`` paths, its
        triangles freed before the next scene's are made)."""
        need = {}
        for j in idx:
            c = calls[j]
            need.setdefault(c.scene, {}).setdefault(
                (c.size, c.pose), set()).add(self._fc(c))
        frames = {}
        for scene in sorted(need):
            tris = pt.Triangles(*self.soups(scene), self.device, self.dtype)
            for (size, pose), fcs in need[scene].items():
                o, llc, hor, ver = self.poses[pose]
                view = pt.View(o, llc, hor, ver, size[0], size[1])
                px, py = self._coords(size)
                fcs = sorted(fcs)
                per = max(1, self.max_paths // max(1, px.shape[0]))
                for i in range(0, len(fcs), per):
                    chunk = fcs[i:i + per]
                    fc = torch.as_tensor(chunk, device=self.device)
                    fc = fc.repeat_interleave(px.shape[0])
                    s = pt.frame_sum(tris, view, self.sh,
                                     px.repeat(len(chunk)),
                                     py.repeat(len(chunk)), fc)
                    for n, f in enumerate(chunk):
                        frames[(size, pose, scene, f)] = s[
                            n * px.shape[0]:(n + 1) * px.shape[0]]
            del tris
        return frames

    def outputs(self, calls, ks):
        """{k: (accumulator [P, 3] f32, u8 [P, 3])} after each call of
        ``ks`` as the reference makes them, each history replayed once."""
        hists = {k: history(calls, k) for k in ks}
        frames = self._frames(calls, {j for h in hists.values() for j in h})
        out = {}
        for start in {h[0] for h in hists.values()}:
            want = {k for k, h in hists.items() if h[0] == start}
            chain = hists[max(want)]        # the others are its prefixes
            steps = [(frames[(calls[j].size, calls[j].pose, calls[j].scene,
                              self._fc(calls[j]))], calls[j].fc)
                     for j in chain]
            for j, acc in zip(chain, pt.running_average(steps, self.dtype)):
                if j in want:
                    img = pt.tonemap(acc, self.sh.exposure)
                    out[j] = (acc.float().cpu().numpy(), img.cpu().numpy())
        return out


def as_program(calls, seen, snaps, outputs):
    """The judged outputs as ``outputs`` (a Judge's) would give them in
    the program's place: the control's readings go through the same
    comparison as the program's."""
    m = len(snaps[0].after) if snaps else 0
    seen = [Seen(s.call, outputs[s.call][1], outputs[s.call][0])
            for s in seen]
    out = []
    for s in snaps:
        b = before(calls, s.call)
        out.append(Snap(s.call, None if b is None else outputs[b][0][:m],
                        outputs[s.call][0][:m]))
    return seen, out


def numbers(calls, seen, snaps, reference) -> dict:
    """The numbers compared: the judged outputs against the reference's
    ``outputs``."""
    out = {}
    if seen:
        acc = [np.abs(s.accum.astype(np.float64)
                      - reference[s.call][0].astype(np.float64))
               for s in seen]
        img = [np.abs(s.image.astype(np.int64)
                      - reference[s.call][1].astype(np.int64))
               for s in seen]
        out["accum_mae"] = float(np.concatenate(acc).mean())
        out["image_mae"] = float(np.concatenate(img).mean())
    worst = []
    for s in snaps:
        m, fc = len(s.after), calls[s.call].fc
        d = (fc + 1.0) * (s.after.astype(np.float64)
                          - reference[s.call][0][:m].astype(np.float64))
        if s.before is not None:
            b = before(calls, s.call)
            d -= fc * (s.before.astype(np.float64)
                       - reference[b][0][:m].astype(np.float64))
        worst.append(float(np.abs(d).mean()))
    if worst:
        out["frame_mae"] = max(worst)
    return out


def verdict(values: dict, limits: dict):
    """(correct, [(name, value, limit)]): every number the limits name is
    present, finite and at or under its limit."""
    rows, ok = [], True
    for name, limit in limits.items():
        v = values.get(name)
        good = v is not None and np.isfinite(v) and v <= float(limit)
        ok = ok and good
        rows.append((name, v, float(limit)))
    return ok, rows
