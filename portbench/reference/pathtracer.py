"""Plain PyTorch reference of the frames the benchmark judges.

A straightforward progressive path tracer over a triangle soup, written
from the reference renderer's shaders (``compute_dynamic_ray.comp`` for
path shading, ``compute.comp`` for the fixed-light tier): per pixel a PCG
seed mixed with the frame counter, a jittered camera ray, up to
``max_bounces`` closest hits with Lambertian / metal / emissive response,
the white-to-blue sky on a miss, and a running average with a sqrt-gamma
u8 tonemap. It knows nothing of the measured program: no BVH, no packed
tables, no kernels. Closest hits are found by brute force over groups of
consecutive triangles, a group's box only culling pairs, so the hit does
not depend on how triangles are grouped.

Where two evaluation orders are both the shader's formula, the one the
measured program documents is taken (the camera ray's sum, normalising by
a reciprocal), so the two agree to the bit on most paths and a reading
measures real disagreement. Every float op runs in ``dtype``: float32 is
the reference, bfloat16 the control that must fail the comparison.

Divisions by a constant go through a 0-d tensor: PyTorch's CUDA
``tensor / python_float`` multiplies by a reciprocal, which is not IEEE
division.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

M32 = 0xFFFFFFFF
REJECTION_ROUNDS = 24      # bounded rejection sampling, zero vector after
GROUP = 64                 # triangles a culling group
MAT_LAMBERTIAN, MAT_METAL, MAT_FUZZY, MAT_EMISSIVE = 0.0, 1.0, 2.0, 3.0


@dataclasses.dataclass(frozen=True)
class Shading:
    """The frame settings the reference needs (a subset of the render
    configuration, with the same meaning)."""

    max_bounces: int = 10
    t_min: float = 1e-3
    t_max: float = 1e4
    fuzz: float = 0.3
    det_eps: float = 1e-5
    samples_per_pixel: int = 1
    emissive_emits: bool = True
    fixed_light: bool = False
    sky: bool = True
    exposure: float = 0.0


def pcg(v: torch.Tensor) -> torch.Tensor:
    """PCG output hash, u32 values carried in int64."""
    state = (v * 747796405 + 2891336453) & M32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & M32
    return (word >> 22) ^ word


def _c(v, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _norm(a):
    inv = 1.0 / torch.sqrt(_dot(a, a))
    return tuple(x * inv for x in a)


class Triangles:
    """A triangle soup on ``device`` in ``dtype``: per triangle v0, the two
    edges, the unit normal normalize(cross(e1, e2)) and the material (rgb,
    type); culling boxes of GROUP consecutive triangles."""

    def __init__(self, verts: np.ndarray, mats: np.ndarray, device,
                 dtype=torch.float32):
        verts = np.asarray(verts, np.float32).reshape(-1, 3, 3)
        mats = np.asarray(mats, np.float32).reshape(-1, 4)
        n = verts.shape[0]
        self.count = n
        self.dtype = dtype
        self.device = torch.device(device)
        pad = (-n) % GROUP
        v = torch.from_numpy(verts).to(self.device).to(dtype)
        v0 = v[:, 0]
        e1 = v[:, 1] - v0
        e2 = v[:, 2] - v0
        nrm = torch.stack(_cross(e1.unbind(1), e2.unbind(1)), 1)
        nlen = torch.sqrt((nrm * nrm).sum(1, keepdim=True))
        nrm = torch.where(nlen > 0, nrm / torch.where(nlen > 0, nlen, 1.0),
                          0.0)
        zero = torch.zeros((pad, 3), dtype=dtype, device=self.device)
        # Padding triangles are all-zero: det == 0, never hit.
        self.v0 = torch.cat([v0, zero]).T.contiguous()     # [3, Tp]
        self.e1 = torch.cat([e1, zero]).T.contiguous()
        self.e2 = torch.cat([e2, zero]).T.contiguous()
        self.normal = torch.cat([nrm, zero]).T.contiguous()
        m = torch.from_numpy(mats).to(self.device)
        self.albedo = torch.cat([m[:, 0:3].to(dtype), zero]).T.contiguous()
        self.mtype = torch.cat([m[:, 3], torch.full(
            (pad,), -1.0, device=self.device)])             # f32 codes
        # Group boxes from the real triangles, widened so rounding in the
        # slab test never culls a hit.
        lo = v.amin(1)
        hi = v.amax(1)
        inf = torch.full((pad, 3), float("inf"), dtype=dtype,
                         device=self.device)
        lo = torch.cat([lo, inf]).view(-1, GROUP, 3).amin(1)
        hi = torch.cat([hi, -inf]).view(-1, GROUP, 3).amax(1)
        if n:
            ext = float((v.amax((0, 1)) - v.amin((0, 1))).abs().max())
        else:
            ext = 1.0
        widen = 1e-3 * max(ext, 1.0)
        self.box_lo = (lo - widen).T.contiguous()           # [3, G]
        self.box_hi = (hi + widen).T.contiguous()
        self.groups = self.box_lo.shape[1]

    def closest(self, o, d, sh: Shading, ray_chunk: int = 4096,
                pair_chunk: int = 32768):
        """Closest hit of each ray (o, d: 3 tensors [R]) -> (t [R], tri
        index [R], -1 for a miss). Ties go to the lowest index."""
        r = o[0].shape[0]
        dev, dt = self.device, self.dtype
        best_t = torch.full((r,), float("inf"), dtype=dt, device=dev)
        best_i = torch.full((r,), -1, dtype=torch.int64, device=dev)
        if r == 0 or self.count == 0:
            return best_t, best_i
        inv_d = tuple(1.0 / x for x in d)
        for r0 in range(0, r, ray_chunk):
            sl = slice(r0, min(r, r0 + ray_chunk))
            t_en = t_ex = None
            for ax in range(3):
                a = (self.box_lo[ax][None, :] - o[ax][sl, None]) \
                    * inv_d[ax][sl, None]
                b = (self.box_hi[ax][None, :] - o[ax][sl, None]) \
                    * inv_d[ax][sl, None]
                lo, hi = torch.fmin(a, b), torch.fmax(a, b)
                t_en = lo if t_en is None else torch.fmax(t_en, lo)
                t_ex = hi if t_ex is None else torch.fmin(t_ex, hi)
            keep = (t_ex >= t_en) & (t_ex > 0)
            ri, gi = keep.nonzero(as_tuple=True)
            ri = ri + r0
            for p0 in range(0, ri.shape[0], pair_chunk):
                self._pairs(o, d, ri[p0:p0 + pair_chunk],
                            gi[p0:p0 + pair_chunk], sh, best_t, best_i)
        return best_t, best_i

    def _pairs(self, o, d, ri, gi, sh: Shading, best_t, best_i):
        """Moller-Trumbore of each (ray, group) pair's GROUP triangles;
        folds the pair minima into best_t / best_i in place."""
        tri = gi[:, None] * GROUP + torch.arange(GROUP, device=gi.device)
        v0 = [c[tri] for c in self.v0]
        e1 = [c[tri] for c in self.e1]
        e2 = [c[tri] for c in self.e2]
        ro = [c[ri][:, None] for c in o]
        rd = [c[ri][:, None] for c in d]
        pv = _cross(rd, e2)
        det = _dot(e1, pv)
        ok = ~((det > -sh.det_eps) & (det < sh.det_eps))
        inv_det = 1.0 / torch.where(ok, det, 1.0)
        s = [a - b for a, b in zip(ro, v0)]
        u = inv_det * _dot(s, pv)
        ok &= (u >= 0.0) & (u <= 1.0)
        q = _cross(s, e1)
        v = inv_det * _dot(rd, q)
        ok &= (v >= 0.0) & (u + v <= 1.0)
        t = inv_det * _dot(e2, q)
        ok &= (t > sh.t_min) & (t < sh.t_max)
        t = torch.where(ok, t, float("inf"))
        pt, pj = t.min(1)                   # first index on a tie
        pi = tri.gather(1, pj[:, None]).squeeze(1)
        hit = torch.isfinite(pt)
        ri, pt, pi = ri[hit], pt[hit], pi[hit]
        if ri.numel() == 0:
            return
        # Per ray: the least t over its pairs, then the least index
        # among the pairs at that t, then merged with what came before.
        n = best_t.shape[0]
        ct = torch.full((n,), float("inf"), dtype=pt.dtype,
                        device=pt.device).scatter_reduce(
            0, ri, pt, "amin", include_self=True)
        at = pt == ct[ri]
        big = torch.iinfo(torch.int64).max
        ci = torch.full((n,), big, dtype=torch.int64,
                        device=pt.device).scatter_reduce(
            0, ri[at], pi[at], "amin", include_self=True)
        ci = torch.where(ci == big, -1, ci)
        better = (ct < best_t) | ((ct == best_t) & (ci >= 0)
                                  & ((best_i < 0) | (ci < best_i)))
        best_t.copy_(torch.where(better, ct, best_t))
        best_i.copy_(torch.where(better, ci, best_i))


@dataclasses.dataclass(frozen=True)
class View:
    """A camera's f32 uniforms (as handed to both sides) and the frame's
    resolution."""

    origin: tuple
    lower_left_corner: tuple
    horizontal: tuple
    vertical: tuple
    width: int
    height: int


def _seeds(px, py, fc, width: int, sample: int, spp: int):
    """Progressive seed of each path: pixel index xor PCG of the frame's
    sample stream."""
    pixel = py * width + px
    stream = (fc * spp + sample + 1) & M32
    return pixel ^ pcg((stream * 0x9E3779B9) & M32)


def _unit(seed, dtype):
    """float(u32) / float(0xFFFFFFFF); the divisor rounds to 2**32."""
    return seed.to(dtype) / 4294967296.0


def _in_sphere(seed, active, dtype):
    """Three discarded draws, then up to REJECTION_ROUNDS rounds of three
    until the point falls inside the unit ball (else the zero vector)."""
    for _ in range(3):
        seed = torch.where(active, pcg(seed), seed)
    zero = torch.zeros(seed.shape, dtype=dtype, device=seed.device)
    x, y, z = zero, zero, zero
    need = active
    for _ in range(REJECTION_ROUNDS):
        if not bool(need.any()):
            break
        c = []
        for _ in range(3):
            seed = torch.where(need, pcg(seed), seed)
            c.append(_unit(seed, dtype) * 2.0 - 1.0)
        inside = (c[0] * c[0] + c[1] * c[1] + c[2] * c[2]) < 1.0
        take = need & inside
        x = torch.where(take, c[0], x)
        y = torch.where(take, c[1], y)
        z = torch.where(take, c[2], z)
        need = need & ~inside
    return seed, (x, y, z)


_INV_SQRT3 = float(np.float32(1.0) / np.sqrt(np.float32(3.0)))


def radiance(tris: Triangles, view: View, sh: Shading, px, py, fc,
             sample: int = 0) -> torch.Tensor:
    """One sample of each path (pixel px, py of the view's frame, frame
    counter fc; int64 tensors [N]) -> radiance [N, 3] in tris.dtype."""
    dev, dt = tris.device, tris.dtype
    px, py, fc = (a.to(dev) for a in (px, py, fc))
    n = px.shape[0]
    cam = {k: [_c(float(v), torch.empty(0, dtype=dt, device=dev))
               for v in getattr(view, k)]
           for k in ("origin", "lower_left_corner", "horizontal",
                     "vertical")}
    one = torch.ones(n, dtype=dt, device=dev)
    wdt = _c(float(view.width), one)
    hgt = _c(float(view.height), one)
    seed = _seeds(px, py, fc, view.width, sample, sh.samples_per_pixel)
    fx, fy = px.to(dt), (_c(float(view.height - 1), one) - py.to(dt))
    if sh.fixed_light:
        u, v = fx / wdt, fy / hgt
    else:
        seed = pcg(seed)
        ju = _unit(seed, dt)
        seed = pcg(seed)
        jv = _unit(seed, dt)
        u, v = (fx + ju) / wdt, (fy + jv) / hgt
    o = tuple(cam["origin"][i].expand(n) for i in range(3))
    d = _norm(tuple(cam["lower_left_corner"][i]
                    + (cam["horizontal"][i] * u + cam["vertical"][i] * v)
                    - cam["origin"][i] for i in range(3)))
    zero = torch.zeros(n, dtype=dt, device=dev)

    if sh.fixed_light:
        t, tri = tris.closest(o, d, sh)
        hit = tri >= 0
        ti = torch.where(hit, tri, 0)
        nrm = [c[ti] for c in tris.normal]
        inten = torch.clamp_min((nrm[0] + nrm[1] + nrm[2]) * _INV_SQRT3,
                                0.0) * 0.8 + 0.2
        return torch.stack([torch.where(hit, c[ti] * inten, zero)
                            for c in tris.albedo], 1)

    color = torch.zeros((n, 3), dtype=dt, device=dev)
    atten = torch.ones((n, 3), dtype=dt, device=dev)
    o = torch.stack(o, 1)
    d = torch.stack(d, 1)
    live = torch.arange(n, device=dev)
    for _ in range(sh.max_bounces):
        if live.numel() == 0:
            break
        lo, ld = o[live].unbind(1), d[live].unbind(1)
        la, ls = atten[live], seed[live]
        t, tri = tris.closest(lo, ld, sh)
        hit = tri >= 0
        miss = ~hit
        if sh.sky:
            unit = _norm(ld)
            ts = 0.5 * (unit[1] + 1.0)
            omt = 1.0 - ts
            sky = torch.stack([omt + ts * 0.5, omt + ts * 0.7,
                               omt + ts * 1.0], 1)
            color[live[miss]] = la[miss] * sky[miss]
        ti = torch.where(hit, tri, 0)
        mt = tris.mtype[ti]
        nrm = [c[ti] for c in tris.normal]
        flip = _dot(ld, nrm) > 0.0
        nrm = [torch.where(flip, -c, c) for c in nrm]
        alb = torch.stack([c[ti] for c in tris.albedo], 1)
        is_lam = hit & (mt == MAT_LAMBERTIAN)
        is_met = hit & ((mt == MAT_METAL) | (mt == MAT_FUZZY))
        is_emi = hit & (mt == MAT_EMISSIVE)
        ls, sph = _in_sphere(ls, is_lam | is_met, dt)
        slen = torch.sqrt(_dot(sph, sph))
        isl = 1.0 / torch.where(slen > 0.0, slen, 1.0)
        lam = [nc + sc * isl for nc, sc in zip(nrm, sph)]
        degen = torch.sqrt(_dot(lam, lam)) < 1e-4
        lam = [torch.where(degen, nc, lc) for nc, lc in zip(nrm, lam)]
        nd = _norm(ld)
        dn = _dot(nd, nrm)
        fz = torch.where(mt == MAT_FUZZY, _c(sh.fuzz, dn), 0.0)
        met = [(a - 2.0 * dn * nc) + fz * sc
               for a, nc, sc in zip(nd, nrm, sph)]
        raw = [torch.where(is_lam, a, b) for a, b in zip(lam, met)]
        rl = torch.sqrt(_dot(raw, raw))
        irl = 1.0 / torch.where(rl > 0.0, rl, 1.0)
        nd2 = [c * irl for c in raw]
        met_ok = _dot(nd2, nrm) > 0.0
        scat = is_lam | (is_met & met_ok)
        if sh.emissive_emits:
            color[live[is_emi]] = color[live[is_emi]] \
                + alb[is_emi] * la[is_emi]
        tt = torch.where(hit, t, 0.0)
        hp = torch.stack([oc + dc * tt for oc, dc in zip(lo, ld)], 1)
        keep = live[scat]
        o[keep] = hp[scat]
        d[keep] = torch.stack(nd2, 1)[scat]
        atten[keep] = la[scat] * alb[scat]
        seed[live] = ls
        live = keep
    # Paths still bouncing after max_bounces keep colour 0.
    return color


def running_average(history, dtype=torch.float32):
    """Replay of the running average over a history of frames, a list of
    (s [N, 3], frame counter) with s the frame's radiance summed over its
    samples and divided by spp: yields the accumulator [N, 3] after each
    frame, ops in the order acc = (acc * fc + s) / (fc + 1). Starts from
    zeros, which a first frame at counter 0 overwrites."""
    acc = None
    for s, fc in history:
        if acc is None:
            acc = torch.zeros(s.shape, dtype=dtype, device=s.device)
        f = _c(float(fc), acc)
        acc = (acc * f + s.to(dtype)) / (f + 1.0)
        yield acc


def accumulate(history, dtype=torch.float32) -> torch.Tensor:
    """The accumulator after the last frame of ``history`` (see
    ``running_average``)."""
    acc = None
    for acc in running_average(history, dtype):
        pass
    return acc


def frame_sum(tris: Triangles, view: View, sh: Shading, px, py, fc):
    """A frame's radiance at pixels (px, py), summed over its samples in
    sample order and divided by spp -> [N, 3]."""
    total = None
    for s in range(sh.samples_per_pixel):
        r = radiance(tris, view, sh, px, py, fc, sample=s)
        total = r if total is None else total + r
    return total / _c(float(sh.samples_per_pixel), total)


def tonemap(acc: torch.Tensor, exposure: float = 0.0) -> torch.Tensor:
    """Exposure, sqrt gamma, u8 (round half to even)."""
    scale = torch.exp2(_c(exposure, acc))
    g = torch.sqrt(torch.clamp_min(acc * scale, 0.0))
    return torch.clamp(torch.round(g * 255.0), 0.0, 255.0).to(torch.uint8)
