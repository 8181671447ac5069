"""Kernel B: one fused walk + shade round (``csrc/bounce12.cu``).

Replaces the Pallas kernel ``raytracer_tpu/kernels/pallas_mega.py``
``_kernel_core`` as built by ``make_kernel(carry_color=False,
key_mode="cid")`` and called by ``bounce_megakernel12``: up to ``bcap``
iterations of the kernel A walk plus the material model, with the
no-color carry, the per-ray budget kill, the rays/live counts and the next
round's ``cid`` sort key.

Round state is one i32[13, w] tensor, one row per field (``ROW_*``): f32
bits of origin, direction and atten, the PCG seed bits, the alive flag,
the bounces-left budget and the pixel id. The sorted-round glue gathers it
with one ``index_select`` per round (``kernels/wavefront.py``).

Per-ray semantics: a ray runs ``b < bcap`` iterations while alive. At
``bcap == 1`` (the only value on the main path) this is exactly the TPU
kernel's result. At ``bcap > 1`` the TPU tile keeps iterating while any of
its rays is alive and re-zeroes the winner cluster id of rays that died
earlier, so only the cid bits of those dead rays' keys differ.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.core.fast_types import FastScene
from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.kernels import cuda_build, launches
from raytracer_tpu_torch.kernels.rng import M32, REJECTION_ROUNDS, pcg
from raytracer_tpu_torch.kernels.trace import _check_scene, walk_plain

ROW_SEED, ROW_ALIVE, ROW_BUDGET, ROW_PIX = 9, 10, 11, 12
STATE_ROWS = 13
UNIFORM_BUDGET = 1 << 30   # never gates: the bounce cap alone does


def pack_state(ray_o, ray_d, atten, seed, alive, budget, pix):
    """Round state i32[13, w] from SoA fields (seed: u32 values in int64;
    budget: int or i32[w])."""
    w = alive.shape[0]
    dev = alive.device
    st = torch.empty((STATE_ROWS, w), dtype=torch.int32, device=dev)
    f = st[0:9].view(torch.float32)
    for j, c in enumerate((*ray_o, *ray_d, *atten)):
        f[j] = c
    st[ROW_SEED] = seed.to(torch.int32)
    st[ROW_ALIVE] = alive.to(torch.int32)
    st[ROW_BUDGET] = budget
    st[ROW_PIX] = pix
    return st


def unpack_floats(state: torch.Tensor):
    """(ray_o, ray_d, atten) f32 views of a round state."""
    f = state[0:9].view(torch.float32)
    return (f[0], f[1], f[2]), (f[3], f[4], f[5]), (f[6], f[7], f[8])


def _unit_two_step(seed):
    """pallas_mega._unit: u32 -> i32 -> f32, + 2^32 where negative, then
    / 2^32: two roundings, unlike rng.to_unit_float."""
    i = torch.where(seed >= 2 ** 31, seed - 2 ** 32, seed)
    f = i.to(torch.float32)
    f = torch.where(i < 0, f + 4294967296.0, f)
    return f / 4294967295.0


def _sphere(seed, active):
    """pallas_mega._sphere: 3 discarded draws, then REJECTION_ROUNDS
    masked rounds of 3 draws (two-step unit conversion)."""
    for _ in range(3):
        seed = torch.where(active, pcg(seed), seed)
    zero = torch.zeros(active.shape, dtype=torch.float32,
                       device=active.device)
    x, y, z = zero, zero, zero
    need = active
    for _ in range(REJECTION_ROUNDS):
        c = []
        for _ in range(3):
            seed = torch.where(need, pcg(seed), seed)
            c.append(_unit_two_step(seed) * 2.0 - 1.0)
        cx, cy, cz = c
        inside = (cx * cx + cy * cy + cz * cz) < 1.0
        take = need & inside
        x = torch.where(take, cx, x)
        y = torch.where(take, cy, y)
        z = torch.where(take, cz, z)
        need = need & ~inside
    return seed, x, y, z


def _shade(hit_out, o, d, a, seed, alive, sky_on: bool, cfg: RenderConfig):
    """pallas_mega._kernel_core shade(), no-color carry."""
    t = hit_out[0]
    nx, ny, nz = hit_out[1], hit_out[2], hit_out[3]
    albr, albg, albb = hit_out[4], hit_out[5], hit_out[6]
    mt = hit_out[7]
    hit = alive & (t < cfg.t_max)
    miss = alive & ~(t < cfg.t_max)
    rdx, rdy, rdz = d
    dlen = torch.sqrt(rdx * rdx + rdy * rdy + rdz * rdz)
    idl = 1.0 / torch.where(dlen > 0.0, dlen, 1.0)
    tsky = 0.5 * (rdy * idl + 1.0)
    omt = 1.0 - tsky
    zero = torch.zeros_like(omt)
    sk = ((omt + tsky * 0.5, omt + tsky * 0.7, omt + tsky * 1.0) if sky_on
          else (zero, zero, zero))

    is_lam = mt == 0.0
    is_metal = (mt == 1.0) | (mt == 2.0)
    is_emis = mt == 3.0
    needs = hit & (is_lam | is_metal)
    seed, sphx, sphy, sphz = _sphere(seed, needs)
    slen = torch.sqrt(sphx * sphx + sphy * sphy + sphz * sphz)
    isl = 1.0 / torch.where(needs & (slen > 0.0), slen, 1.0)
    lamx, lamy, lamz = nx + sphx * isl, ny + sphy * isl, nz + sphz * isl
    laml = torch.sqrt(lamx * lamx + lamy * lamy + lamz * lamz)
    degen = laml < 1e-4
    lamx = torch.where(degen, nx, lamx)
    lamy = torch.where(degen, ny, lamy)
    lamz = torch.where(degen, nz, lamz)

    fz = torch.where(mt == 2.0, torch.tensor(cfg.fuzz, dtype=torch.float32,
                                             device=mt.device), zero)
    ndx, ndy, ndz = rdx * idl, rdy * idl, rdz * idl
    dn = ndx * nx + ndy * ny + ndz * nz
    metx = (ndx - 2.0 * dn * nx) + fz * sphx
    mety = (ndy - 2.0 * dn * ny) + fz * sphy
    metz = (ndz - 2.0 * dn * nz) + fz * sphz
    rawx = torch.where(is_lam, lamx, metx)
    rawy = torch.where(is_lam, lamy, mety)
    rawz = torch.where(is_lam, lamz, metz)
    rl = torch.sqrt(rawx * rawx + rawy * rawy + rawz * rawz)
    irl = 1.0 / torch.where(rl > 0.0, rl, 1.0)
    newx, newy, newz = rawx * irl, rawy * irl, rawz * irl
    met_ok = (newx * nx + newy * ny + newz * nz) > 0.0
    scattered = hit & (is_lam | (is_metal & met_ok))

    emis = hit & is_emis if cfg.emissive_emits else torch.zeros_like(hit)
    a_new = []
    for at, s, alb in zip(a, sk, (albr, albg, albb)):
        dep = torch.where(miss, at * s, zero)
        dep = torch.where(emis, alb * at, dep)
        dep = torch.where(alive, dep, at)     # dead on entry: keep deposit
        a_new.append(torch.where(scattered, at * alb, dep))
    hit_pos = tuple(oc + dc * t for oc, dc in zip(o, d))
    o = tuple(torch.where(scattered, h, oc) for h, oc in zip(hit_pos, o))
    d = tuple(torch.where(scattered, n, dc)
              for n, dc in zip((newx, newy, newz), d))
    return o, d, tuple(a_new), seed, scattered


def bounce12_plain(scene: FastScene, state: torch.Tensor, bcap: int,
                   sky_on: bool, cfg: RenderConfig):
    """Plain version of kernel B -> (state' i32[13, w], key i32[w],
    counts int64[2] = (rays traced, live at the end))."""
    _check_state(scene, state)
    launches.plain["bounce12"] += 1
    o, d, a = unpack_floats(state)
    seed = state[ROW_SEED].to(torch.int64) & M32
    act = state[ROW_ALIVE] != 0
    bud = state[ROW_BUDGET].clone()
    cid = torch.zeros_like(bud)
    rays = torch.zeros((), dtype=torch.int64, device=state.device)
    for _ in range(bcap):
        entered = act
        rays = rays + entered.sum()
        hit_out, cid_new = walk_plain(scene.nodes4, scene.clusters, o, d,
                                      entered, cfg.t_min, cfg.t_max,
                                      cfg.det_eps)
        cid = torch.where(entered, cid_new, cid)
        o, d, a, seed, act = _shade(hit_out, o, d, a, seed, entered, sky_on,
                                    cfg)
        bud = bud - entered.to(torch.int32)
        killed = (bud <= 0) & act
        a = tuple(torch.where(killed, 0.0, c) for c in a)
        act = act & (bud > 0)
    out = pack_state(o, d, a, seed, act, bud, state[ROW_PIX])
    octant = ((d[0] > 0.0).to(torch.int32)
              | ((d[1] > 0.0).to(torch.int32) << 1)
              | ((d[2] > 0.0).to(torch.int32) << 2))
    key = ((~act).to(torch.int32) << 30) | (cid << 3) | octant
    counts = torch.stack([rays, act.sum()])
    return out, key, counts


def _check_state(scene: FastScene, state: torch.Tensor) -> None:
    _check_scene(scene, state.device)
    if (state.dtype != torch.int32 or state.dim() != 2
            or state.shape[0] != STATE_ROWS or not state.is_contiguous()):
        raise ValueError("state must be contiguous i32[13, w]")


def bounce12(scene: FastScene, state: torch.Tensor, bcap: int, sky_on: bool,
             cfg: RenderConfig):
    """Kernel B on CUDA tensors, its plain version on CPU tensors (same
    arguments and results as ``bounce12_plain``)."""
    if state.device.type == "cpu":
        return bounce12_plain(scene, state, bcap, sky_on, cfg)
    if state.device.type != "cuda":
        raise ValueError(f"unsupported device {state.device}")
    _check_state(scene, state)
    w = state.shape[1]
    out = torch.empty_like(state)
    key = torch.empty(w, dtype=torch.int32, device=state.device)
    counts = torch.zeros(2, dtype=torch.int64, device=state.device)
    lib = cuda_build.library()
    stream = torch.cuda.current_stream(state.device).cuda_stream
    cuda_build.check(lib.rt_bounce12(
        scene.nodes4.data_ptr(), scene.clusters.data_ptr(),
        state.data_ptr(), out.data_ptr(), key.data_ptr(), counts.data_ptr(),
        w, int(bcap), int(bool(sky_on)), cfg.fuzz, int(cfg.emissive_emits),
        cfg.t_min, cfg.t_max, cfg.det_eps, stream), "rt_bounce12")
    launches.kernel["bounce12"] += 1
    return out, key, counts
