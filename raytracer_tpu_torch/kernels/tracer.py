"""Ray generation, shading and the per-ray path in plain torch ops.

The port of ``raytracer_tpu.kernels.tracer``: ``initial_seed``,
``make_primary_rays``, ``sky_color``, ``scatter``, ``shade`` and
``fixed_light_color`` (the main path's bounce 0), and the per-ray
GLSL-parity path over a ``GpuScene``: ``traverse`` (the stackless
skip-link walk of the binary BVH, every ray in lockstep) and
``render_linear``. The JAX package runs that path as XLA while loops with
no Pallas kernel, so it stays plain PyTorch on the card too: each walk
step and each bounce ends in a host read of its ``.any()`` loop condition
(one sync an iteration, as the JAX loop condition is evaluated each
iteration). Vectors are (x, y, z) tuples of flat [P] f32 tensors, and
every expression keeps the JAX version's evaluation order, so results are
bit-equal where the JAX side is evaluated without FMA contraction.

Division by a non-power-of-two constant goes through a 0-d tensor on the
ray device: PyTorch's CUDA ``tensor / python_float`` multiplies by the
reciprocal, which is not IEEE division.

``shade`` is a kernel's wrapper: on CUDA tensors one launch of the shade
kernel (``csrc/front.cu``, the device code shared with the mega kernel in
``csrc/shade.cuh``) in place of ~1,660 plain ops, most of them the
rejection sampler's 24 rounds; on CPU tensors its plain version
``shade_plain``, which the plain megakernel also calls with its ``draws``
count.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from raytracer_tpu_torch.core.types import (CameraUniforms, GpuScene,
                                            RenderConfig)
from raytracer_tpu_torch.kernels import cuda_build, launches, rng


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _length(a):
    return torch.sqrt(_dot(a, a))


def _scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _normalize(a):
    return _scale(a, 1.0 / _length(a))


def _where(c, a, b):
    return tuple(torch.where(c, x, y) for x, y in zip(a, b))


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def sky_color(d):
    """White->blue vertical gradient (compute_dynamic_ray.comp:81-85)."""
    unit = _normalize(d)
    t = 0.5 * (unit[1] + 1.0)
    omt = 1.0 - t
    return (omt + t * 0.5, omt + t * 0.7, omt + t * 1.0)


class TraversalResult(NamedTuple):
    closest_t: torch.Tensor   # f32[P]
    hit: torch.Tensor         # bool[P]
    normal: tuple             # 3 x f32[P], flipped toward the ray
    mat_albedo: tuple         # 3 x f32[P]
    mat_type: torch.Tensor    # f32[P]


class ScatterResult(NamedTuple):
    seed: torch.Tensor
    new_dir: tuple
    attenuation: tuple
    scattered: torch.Tensor
    emitted: tuple


def scatter(seed, ray_d, normal, albedo, mtype, hit,
            cfg: RenderConfig, draws: list | None = None) -> ScatterResult:
    """Material response: Lambertian, metal / fuzzy metal, emissive.
    ``draws``: see ``rng.random_vec3_in_unit_sphere``."""
    is_lam = mtype == 0.0
    is_metal = (mtype == 1.0) | (mtype == 2.0)
    is_emis = mtype == 3.0

    needs_draw = hit & (is_lam | is_metal)
    seed, sph = rng.random_vec3_in_unit_sphere(seed, needs_draw, draws)

    sph_len = _length(sph)
    inv_sph = 1.0 / torch.where(needs_draw & (sph_len > 0.0), sph_len, 1.0)
    unit_sph = _scale(sph, inv_sph)
    lam_dir = tuple(n + u for n, u in zip(normal, unit_sph))
    lam_degenerate = _length(lam_dir) < 1e-4
    lam_dir = _where(lam_degenerate, normal, lam_dir)

    zero = torch.zeros_like(mtype)
    fuzz = torch.where(mtype == 2.0, _const(cfg.fuzz, mtype), zero)
    nd = _normalize(ray_d)
    dn = _dot(nd, normal)
    refl = tuple(i - 2.0 * dn * n for i, n in zip(nd, normal))
    met_dir = tuple(r + s * fuzz for r, s in zip(refl, sph))

    raw = _where(is_lam, lam_dir, met_dir)
    raw_len = _length(raw)
    new_dir = _scale(raw, 1.0 / torch.where(raw_len > 0.0, raw_len, 1.0))

    met_ok = _dot(new_dir, normal) > 0.0
    scattered = hit & (is_lam | (is_metal & met_ok))

    if cfg.emissive_emits:
        emis_active = hit & is_emis
    else:
        emis_active = torch.zeros_like(hit)
    emitted = _where(emis_active, albedo, (zero, zero, zero))
    return ScatterResult(seed, new_dir, albedo, scattered, emitted)


def shade_plain(res: TraversalResult, ray_o, ray_d, color, atten, seed,
                alive, sky_on: bool, cfg: RenderConfig,
                draws: list | None = None):
    """One bounce of shading: sky on miss, scatter / emit / absorb on hit.
    Returns advanced (ray_o, ray_d, color, atten, seed, alive).
    ``draws``: see ``rng.random_vec3_in_unit_sphere``."""
    hit = alive & res.hit
    miss = alive & ~hit

    sky = sky_color(ray_d)
    if not sky_on:
        sky = tuple(torch.zeros_like(c) for c in sky)
    color = _where(miss, tuple(a * s for a, s in zip(atten, sky)), color)

    sc = scatter(seed, ray_d, res.normal, res.mat_albedo, res.mat_type,
                 hit, cfg, draws)
    color = tuple(c + e * a for c, e, a in zip(color, sc.emitted, atten))
    hit_pos = tuple(o + d * res.closest_t for o, d in zip(ray_o, ray_d))
    atten = _where(sc.scattered,
                   tuple(a * b for a, b in zip(atten, sc.attenuation)), atten)
    ray_o = _where(sc.scattered, hit_pos, ray_o)
    ray_d = _where(sc.scattered, sc.new_dir, ray_d)
    return ray_o, ray_d, color, atten, sc.seed, sc.scattered


def _rows(xs, dtype, p: int, device, what: str) -> list:
    """Each of ``xs`` as a contiguous [p] tensor of ``dtype`` on ``device``
    (a strided or broadcast view is copied), else raise."""
    out = []
    for x in xs:
        if x.dtype != dtype or x.shape != (p,) or x.device != device:
            raise ValueError(f"{what} must be {dtype}[{p}] on {device}")
        out.append(x.contiguous())
    return out


def shade(res: TraversalResult, ray_o, ray_d, color, atten, seed, alive,
          sky_on: bool, cfg: RenderConfig):
    """``shade_plain`` as one launch of the shade kernel
    (``csrc/front.cu``) on CUDA tensors, ``shade_plain`` itself on CPU
    tensors; the same arguments (f32 [P] rows, ``seed`` u32 values in
    int64, ``res.hit`` and ``alive`` bool) and results, bit for bit."""
    dev = alive.device
    if dev.type == "cpu":
        launches.plain["shade"] += 1
        return shade_plain(res, ray_o, ray_d, color, atten, seed, alive,
                           sky_on, cfg)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    p = alive.shape[0]
    ins = (_rows((res.closest_t, *res.normal, *res.mat_albedo,
                  res.mat_type), torch.float32, p, dev, "the hit record")
           + _rows((res.hit, alive), torch.bool, p, dev, "hit and alive")
           + _rows((*ray_o, *ray_d, *color, *atten), torch.float32, p, dev,
                   "the rays, colour and atten")
           + _rows((seed,), torch.int64, p, dev, "seed"))
    table = (ctypes.c_void_p * len(ins))(*(x.data_ptr() for x in ins))
    out = torch.empty((12, p), dtype=torch.float32, device=dev)
    seed_out = torch.empty(p, dtype=torch.int64, device=dev)
    scattered = torch.empty(p, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_build.check(cuda_build.library().rt_shade(
        table, out.data_ptr(), seed_out.data_ptr(), scattered.data_ptr(), p,
        int(sky_on), int(cfg.emissive_emits), cfg.fuzz, stream), "rt_shade")
    launches.kernel["shade"] += 1
    rows = out.unbind(0)
    return rows[0:3], rows[3:6], rows[6:9], rows[9:12], seed_out, scattered


# C12 light: 1 / sqrt(3) rounded once to f32, as XLA folds the constant.
_INV_SQRT3 = float(np.float32(1.0) / np.sqrt(np.float32(3.0)))


def fixed_light_color(res: TraversalResult):
    """C12 shading (shaders/compute.comp:196-204): light direction
    normalize(1, 1, 1), intensity max(0, n.l) * 0.8 + 0.2, albedo *
    intensity on a hit, black elsewhere. Expects raw (unflipped) normals:
    traversal with cfg.shading == "fixed_light"."""
    ndotl = (res.normal[0] + res.normal[1] + res.normal[2]) * _INV_SQRT3
    intensity = torch.clamp_min(ndotl, 0.0) * 0.8 + 0.2
    zero = torch.zeros_like(intensity)
    return tuple(torch.where(res.hit, a * intensity, zero)
                 for a in res.mat_albedo)


def make_primary_rays(cam: CameraUniforms, cfg: RenderConfig, seed, xx, yy,
                      global_height: int, jitter: bool = True):
    """Jittered camera rays (compute_dynamic_ray.comp:158-173), SoA.
    xx/yy: flat int pixel coordinates (yy global). Returns (seed, ray_o,
    ray_d) with ray_o broadcast views of the camera origin. ``jitter=False``
    is the C12 ray-gen (compute.comp:123-124): no jitter, no draws."""
    p = xx.shape[0]
    if jitter:
        all_on = torch.ones(p, dtype=torch.bool, device=xx.device)
        seed, ju = rng.random_float(seed, all_on)
        seed, jv = rng.random_float(seed, all_on)
    else:
        ju = jv = torch.zeros(p, dtype=torch.float32, device=xx.device)
    u = (xx.to(torch.float32) + ju) / _const(cfg.width, ju)
    v = ((_const(global_height - 1, jv) - yy.to(torch.float32)) + jv) \
        / _const(global_height, jv)

    origin = tuple(cam.origin[i].expand(p) for i in range(3))
    d = tuple(cam.lower_left_corner[i]
              + (cam.horizontal[i] * u + cam.vertical[i] * v)
              - cam.origin[i] for i in range(3))
    return seed, origin, _normalize(d)


def initial_seed(cam: CameraUniforms, cfg: RenderConfig, pixel,
                 sample_index: int):
    """Reference mode: seed = pixel index. Progressive: mix frame and
    sample. ``pixel``: u32 values in an int64 tensor."""
    if cfg.rng_mode == "reference":
        return pixel
    stream = (cam.frame_count.to(torch.int64) * cfg.samples_per_pixel
              + sample_index + 1) & rng.M32
    return pixel ^ rng.pcg((stream * 0x9E3779B9) & rng.M32)


def traverse(scene: GpuScene, ray_o, ray_d, active,
             cfg: RenderConfig) -> TraversalResult:
    """Closest triangle hit of every ray, in lockstep (the JAX
    ``tracer.traverse``): a box-hit internal node steps to i + 1 (its left
    child), anything else to ``node_skip[i]``; a ray is done when its node
    reaches ``num_nodes``, and dead rays start there. Normals are flipped
    toward the ray except for the fixed-light tier."""
    bvh = scene.bvh
    num_nodes = scene.num_nodes
    p = ray_o[0].shape[0]
    dev = ray_o[0].device
    tri9 = scene.tri_verts.reshape(-1, 9)
    inv_d = (1.0 / ray_d[0], 1.0 / ray_d[1], 1.0 / ray_d[2])

    node = torch.where(active, 0, num_nodes).to(torch.int32)
    closest_t = torch.full((p,), cfg.t_max, dtype=torch.float32, device=dev)
    hit_tri = torch.full((p,), -1, dtype=torch.int32, device=dev)
    nx = torch.zeros(p, dtype=torch.float32, device=dev)
    ny, nz = torch.zeros_like(nx), torch.zeros_like(nx)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    while bool((node < num_nodes).any()):
        in_flight = node < num_nodes
        safe = torch.where(in_flight, node, zero).to(torch.int64)
        nmin = bvh.node_min.index_select(0, safe)
        nmax = bvh.node_max.index_select(0, safe)
        tri = bvh.node_tri.index_select(0, safe)
        skip = bvh.node_skip.index_select(0, safe)

        # Slab test, t-bounded by the ray's closest hit; min / max
        # propagate NaN as jnp.minimum / maximum do.
        t_enter = t_exit = None
        for ax in range(3):
            t0 = (nmin[:, ax] - ray_o[ax]) * inv_d[ax]
            t1 = (nmax[:, ax] - ray_o[ax]) * inv_d[ax]
            lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
            t_enter = lo if t_enter is None else torch.maximum(t_enter, lo)
            t_exit = hi if t_exit is None else torch.minimum(t_exit, hi)
        box_hit = ((t_exit > t_enter) & (t_exit > cfg.t_min)
                   & (t_enter < closest_t) & in_flight)
        is_leaf = tri >= 0
        leaf_hit = box_hit & is_leaf

        # Moller-Trumbore for rays at a hit leaf.
        t_idx = torch.where(leaf_hit, tri, zero)
        tv = tri9.index_select(0, t_idx.to(torch.int64))
        v0 = (tv[:, 0], tv[:, 1], tv[:, 2])
        e1 = (tv[:, 3] - tv[:, 0], tv[:, 4] - tv[:, 1], tv[:, 5] - tv[:, 2])
        e2 = (tv[:, 6] - tv[:, 0], tv[:, 7] - tv[:, 1], tv[:, 8] - tv[:, 2])
        pvec = _cross(ray_d, e2)
        det = _dot(e1, pvec)
        ok = ~((det > -cfg.det_eps) & (det < cfg.det_eps))
        inv_det = 1.0 / torch.where(ok, det, 1.0)
        s = _sub(ray_o, v0)
        u = inv_det * _dot(s, pvec)
        ok = ok & (u >= 0.0) & (u <= 1.0)
        qvec = _cross(s, e1)
        v = inv_det * _dot(ray_d, qvec)
        ok = ok & (v >= 0.0) & (u + v <= 1.0)
        t = inv_det * _dot(e2, qvec)
        ok = ok & (t > cfg.t_min) & (t < closest_t)
        upd = leaf_hit & ok

        n_raw = _cross(e1, e2)
        inv_len = 1.0 / torch.where(upd, _length(n_raw), 1.0)
        n_unit = _scale(n_raw, inv_len)
        if cfg.shading != "fixed_light":
            flip = _dot(ray_d, n_unit) > 0.0
            n_unit = _where(flip, _scale(n_unit, -1.0), n_unit)

        closest_t = torch.where(upd, t, closest_t)
        hit_tri = torch.where(upd, t_idx, hit_tri)
        nx = torch.where(upd, n_unit[0], nx)
        ny = torch.where(upd, n_unit[1], ny)
        nz = torch.where(upd, n_unit[2], nz)

        descend = box_hit & ~is_leaf
        node = torch.where(in_flight, torch.where(descend, node + 1, skip),
                           node)

    hit = hit_tri >= 0
    m = scene.materials.index_select(
        0, torch.where(hit, hit_tri, zero).to(torch.int64))
    return TraversalResult(closest_t, hit, (nx, ny, nz),
                           (m[:, 0], m[:, 1], m[:, 2]), m[:, 3])


def render_linear(scene: GpuScene, cam: CameraUniforms, cfg: RenderConfig,
                  sample_index: int = 0, y_offset: int = 0,
                  global_height: int | None = None):
    """One sample per pixel of a band (cfg.height rows from global row
    ``y_offset`` of a ``global_height``-row frame) -> (color f32[3, h*w]
    in raster order, rays traced (int64 tensor)). Bounces run while any
    ray is alive, up to ``cfg.max_bounces``; an exhausted path keeps
    colour 0."""
    if not isinstance(scene, GpuScene):
        raise TypeError("the per-ray path renders a GpuScene "
                        "(scene/builder.build_gpu_scene)")
    h, w = cfg.height, cfg.width
    gh = global_height or h
    p = h * w
    dev = scene.device
    i = torch.arange(p, dtype=torch.int64, device=dev)
    yy = i // w + y_offset
    xx = i % w
    seed = initial_seed(cam, cfg, yy * w + xx, sample_index)
    alive = torch.ones(p, dtype=torch.bool, device=dev)

    if cfg.shading == "fixed_light":
        _, ray_o, ray_d = make_primary_rays(cam, cfg, seed, xx, yy, gh,
                                            jitter=False)
        color = fixed_light_color(traverse(scene, ray_o, ray_d, alive, cfg))
        return torch.stack(color), torch.tensor(p, device=dev)

    seed, ray_o, ray_d = make_primary_rays(cam, cfg, seed, xx, yy, gh)
    zero = torch.zeros(p, dtype=torch.float32, device=dev)
    one = torch.ones(p, dtype=torch.float32, device=dev)
    color, atten = (zero, zero, zero), (one, one, one)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    b = 0
    while b < cfg.max_bounces and bool(alive.any()):
        rays = rays + alive.sum()
        res = traverse(scene, ray_o, ray_d, alive, cfg)
        ray_o, ray_d, color, atten, seed, alive = shade(
            res, ray_o, ray_d, color, atten, seed, alive, cam.sky_host, cfg)
        b += 1
    return torch.stack(color), rays
