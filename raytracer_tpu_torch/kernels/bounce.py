"""Kernel B and its variants: fused walk + shade rounds
(``csrc/bounce12.cu``).

Replaces the Pallas kernel ``raytracer_tpu/kernels/pallas_mega.py``
``_kernel_core`` in its three builds: up to ``bcap`` iterations of the
kernel A walk plus the material model, the per-ray budget, the rays/live
counts and the next round's sort key.

* ``bounce12`` (``make_kernel(carry_color=False)`` via
  ``bounce_megakernel12``, the default rounds): the no-color carry, where a
  dying ray's atten becomes its deposit and a budget kill blacks it out.
* ``bounce15`` (``make_kernel(carry_color=True)`` via ``bounce_megakernel``:
  ``RAYTPU_WAVE=fused`` rounds, the colour-carrying tail and the single
  ``RAYTPU_BOUNCE=pmega`` call): the colour rides in rows of its own; a
  miss writes atten * sky into it, an emissive hit adds albedo * atten,
  atten is kept where the ray does not scatter, a budget kill zeroes
  nothing.
* ``bounce_packed`` (``make_kernel_packed`` via
  ``bounce_megakernel_packed``, ``RAYTPU_WAVE=fused_packed`` rounds): the
  ``bounce15`` core over packed state, sf f32[13, w] (origin, direction,
  colour, atten, alive as 0.0 / 1.0) and si i32[k, w] (seed, then rows
  passed through), with the budget fixed at ``1 << 30``.

Each wrapper takes ``key_mode``, the key it emits (``keys.KERNEL_KEYS``:
``cid``, the winner cluster id of the last walk, by default; ``pd5`` or
``om9``, ``keys.sort_key`` of the advanced state against the root box with
the dead flag at bit 30), and ``ordered`` (``bounce12`` and ``bounce15``
only): False walks without the near-first push order (``walk_plain``), as
``RAYTPU_ORDER_MINW`` levels do. Each (key, order) pair is a build of its
own on the card (``csrc/bounce.cuh``), in the kernel library of the
scene's table layout (``cuda_build.library``), booked in ``launches``
under ``build_name`` with the layout's tag.

Round state is one i32 tensor, one row per field: f32 bits of origin,
direction, [colour,] atten, then the PCG seed bits, the alive flag, the
bounces-left budget and the pixel id (``ROW_*`` count from the end, so they
hold for both layouts): i32[13, w] without the colour, i32[16, w] with it.
The sorted-round glue gathers it with one ``index_select`` per round
(``kernels/wavefront.py``).

Per-ray semantics: a ray runs ``b < bcap`` iterations while alive. At
``bcap == 1`` this is exactly the TPU kernel's result. At ``bcap > 1`` the
TPU tile keeps iterating while any of its rays is alive and re-zeroes the
winner cluster id of rays that died earlier, so only the cid bits of those
dead rays' keys differ.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.core.fast_types import DEFAULT_LAYOUT, FastScene
from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.kernels import cuda_build, launches
from raytracer_tpu_torch.kernels.keys import KERNEL_KEYS, sort_key
from raytracer_tpu_torch.kernels.rng import M32, REJECTION_ROUNDS, pcg
from raytracer_tpu_torch.kernels.trace import (_check_scene, _check_table,
                                               walk_plain)

ROW_SEED, ROW_ALIVE, ROW_BUDGET, ROW_PIX = -4, -3, -2, -1
STATE_ROWS = 13            # no-color carry (bounce12)
COLOR_ROWS = 16            # colour carried (bounce15)
SF_ROWS = 13               # packed floats (bounce_packed)
UNIFORM_BUDGET = 1 << 30   # never gates: the bounce cap alone does


def build_name(kernel: str, key_mode: str = "cid", ordered: bool = True,
               layout=DEFAULT_LAYOUT) -> str:
    """The name a build of ``kernel`` books its launches under: the
    kernel's own for the cid key, the ordered walk and the default table
    layout, else suffixed ("bounce12_pd5", "bounce15_unordered",
    "bounce12_om9_unordered", "bounce12_c4", "bounce15_pd5_w16")."""
    if key_mode not in KERNEL_KEYS:
        raise ValueError(f"kernel B emits no {key_mode!r} key "
                         f"(builds: {', '.join(KERNEL_KEYS)})")
    return cuda_build.kernel_name(
        kernel + ("" if key_mode == "cid" else f"_{key_mode}")
        + ("" if ordered else "_unordered"), layout)


def pack_state(ray_o, ray_d, atten, seed, alive, budget, pix, color=None):
    """Round state from SoA fields: i32[13, w], or i32[16, w] with
    ``color`` (seed: u32 values in int64; budget: int or i32[w])."""
    w = alive.shape[0]
    fields = (*ray_o, *ray_d, *(color or ()), *atten)
    st = torch.empty((len(fields) + 4, w), dtype=torch.int32,
                     device=alive.device)
    f = st[0:len(fields)].view(torch.float32)
    for j, c in enumerate(fields):
        f[j] = c
    st[ROW_SEED] = seed.to(torch.int32)
    st[ROW_ALIVE] = alive.to(torch.int32)
    st[ROW_BUDGET] = budget
    st[ROW_PIX] = pix
    return st


def unpack_floats(state: torch.Tensor):
    """(ray_o, ray_d, color or None, atten) f32 views of a round state."""
    f = state[:-4].view(torch.float32)
    color = (f[6], f[7], f[8]) if f.shape[0] == 12 else None
    return ((f[0], f[1], f[2]), (f[3], f[4], f[5]), color,
            (f[-3], f[-2], f[-1]))


def packed_to_state(sf: torch.Tensor, si: torch.Tensor, budget, pix):
    """Packed state (sf f32[13, w], si i32[k, w] with the seed in row 0)
    -> colour-carrying round state i32[16, w]."""
    st = torch.empty((COLOR_ROWS, sf.shape[1]), dtype=torch.int32,
                     device=sf.device)
    st[0:12] = sf[0:12].view(torch.int32)
    st[ROW_SEED] = si[0]
    st[ROW_ALIVE] = (sf[12] > 0.5).to(torch.int32)
    st[ROW_BUDGET] = budget
    st[ROW_PIX] = pix
    return st


def _unit_two_step(seed):
    """pallas_mega._unit: u32 -> i32 -> f32, + 2^32 where negative, then
    / 2^32: two roundings, unlike rng.to_unit_float."""
    i = torch.where(seed >= 2 ** 31, seed - 2 ** 32, seed)
    f = i.to(torch.float32)
    f = torch.where(i < 0, f + 4294967296.0, f)
    return f / 4294967295.0


def _sphere(seed, active):
    """pallas_mega._sphere: 3 discarded draws, then REJECTION_ROUNDS
    masked rounds of 3 draws (two-step unit conversion). Counts the draws
    in ``launches.work``."""
    launches.work["draws"] += 3 * int(active.sum())
    for _ in range(3):
        seed = torch.where(active, pcg(seed), seed)
    zero = torch.zeros(active.shape, dtype=torch.float32,
                       device=active.device)
    x, y, z = zero, zero, zero
    need = active
    for _ in range(REJECTION_ROUNDS):
        launches.work["draws"] += 3 * int(need.sum())
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


def _shade(hit_out, o, d, c, a, seed, alive, sky_on: bool,
           cfg: RenderConfig):
    """pallas_mega._kernel_core shade(): with the colour carried when
    ``c`` is given, else the no-color carry. Returns (o, d, c, a, seed,
    scattered)."""
    launches.work["shades"] += int(alive.sum())
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
    alb = (albr, albg, albb)
    if c is not None:
        c = tuple(torch.where(miss, at * s, cc) for cc, at, s in zip(c, a, sk))
        c = tuple(torch.where(emis, cc + al * at, cc)
                  for cc, al, at in zip(c, alb, a))
        a_new = [torch.where(scattered, at * al, at) for at, al in zip(a, alb)]
    else:
        a_new = []
        for at, s, al in zip(a, sk, alb):
            dep = torch.where(miss, at * s, zero)
            dep = torch.where(emis, al * at, dep)
            dep = torch.where(alive, dep, at)  # dead on entry: keep deposit
            a_new.append(torch.where(scattered, at * al, dep))
    hit_pos = tuple(oc + dc * t for oc, dc in zip(o, d))
    o = tuple(torch.where(scattered, h, oc) for h, oc in zip(hit_pos, o))
    d = tuple(torch.where(scattered, n, dc)
              for n, dc in zip((newx, newy, newz), d))
    return o, d, c, tuple(a_new), seed, scattered


def _rounds_plain(scene: FastScene, state: torch.Tensor, bcap: int,
                  sky_on: bool, cfg: RenderConfig, key_mode: str = "cid",
                  ordered: bool = True):
    """Up to ``bcap`` walk + shade iterations on a round state (either
    layout) -> (state', key i32[w] of ``key_mode``, counts int64[2] =
    (rays traced, live at the end))."""
    o, d, c, a = unpack_floats(state)
    seed = state[ROW_SEED].to(torch.int64) & M32
    act = state[ROW_ALIVE] != 0
    bud = state[ROW_BUDGET].clone()
    cid = torch.zeros_like(bud)
    rays = torch.zeros((), dtype=torch.int64, device=state.device)
    for _ in range(bcap):
        if not bool(act.any()):
            break   # nothing alive: further iterations change nothing
        entered = act
        rays = rays + entered.sum()
        hit_out, cid_new = walk_plain(scene.node_rows, scene.leaf_rows, o,
                                      d, entered, cfg.t_min, cfg.t_max,
                                      cfg.det_eps, ordered=ordered)
        cid = torch.where(entered, cid_new, cid)
        o, d, c, a, seed, act = _shade(hit_out, o, d, c, a, seed, entered,
                                       sky_on, cfg)
        bud = bud - entered.to(torch.int32)
        if c is None:
            killed = (bud <= 0) & act
            a = tuple(torch.where(killed, 0.0, x) for x in a)
        act = act & (bud > 0)
    out = pack_state(o, d, a, seed, act, bud, state[ROW_PIX], color=c)
    if key_mode == "cid":
        octant = ((d[0] > 0.0).to(torch.int32)
                  | ((d[1] > 0.0).to(torch.int32) << 1)
                  | ((d[2] > 0.0).to(torch.int32) << 2))
        key = ((~act).to(torch.int32) << 30) | (cid << 3) | octant
    else:
        key = sort_key(o, d, act, *scene.bounds(), key_mode,
                       dead_bit=30).to(torch.int32)
    counts = torch.stack([rays, act.sum()])
    return out, key, counts


def bounce12_plain(scene: FastScene, state: torch.Tensor, bcap: int,
                   sky_on: bool, cfg: RenderConfig, key_mode: str = "cid",
                   ordered: bool = True):
    """Plain version of kernel B -> (state' i32[13, w], key i32[w],
    counts int64[2] = (rays traced, live at the end))."""
    _check_state(scene, state, STATE_ROWS)
    launches.plain[build_name("bounce12", key_mode, ordered,
                              scene.layout)] += 1
    return _rounds_plain(scene, state, bcap, sky_on, cfg, key_mode, ordered)


def bounce15_plain(scene: FastScene, state: torch.Tensor, bcap: int,
                   sky_on: bool, cfg: RenderConfig, key_mode: str = "cid",
                   ordered: bool = True):
    """Plain version of the colour-carrying kernel -> (state' i32[16, w],
    key i32[w], counts int64[2])."""
    _check_state(scene, state, COLOR_ROWS)
    launches.plain[build_name("bounce15", key_mode, ordered,
                              scene.layout)] += 1
    return _rounds_plain(scene, state, bcap, sky_on, cfg, key_mode, ordered)


def bounce_packed_plain(scene: FastScene, sf: torch.Tensor, si: torch.Tensor,
                        bcap: int, sky_on: bool, cfg: RenderConfig,
                        key_mode: str = "cid"):
    """Plain version of the packed kernel: sf f32[13, w], si i32[k, w] ->
    (sf', si', key i32[w], counts int64[2]); si rows >= 1 pass through."""
    _check_packed(scene, sf, si)
    launches.plain[build_name("bounce_packed", key_mode,
                              layout=scene.layout)] += 1
    state = packed_to_state(sf, si, UNIFORM_BUDGET, 0)
    out, key, counts = _rounds_plain(scene, state, bcap, sky_on, cfg,
                                     key_mode)
    sf_out = torch.cat([out[0:12].view(torch.float32),
                        out[ROW_ALIVE].to(torch.float32)[None]])
    si_out = torch.cat([out[ROW_SEED][None], si[1:]])
    return sf_out, si_out, key, counts


def _check_state(scene: FastScene, state: torch.Tensor, rows: int) -> None:
    _check_scene(scene, state.device)
    _check_table(scene, "nodes8", 8, state.device)
    if (state.dtype != torch.int32 or state.dim() != 2
            or state.shape[0] != rows or not state.is_contiguous()):
        raise ValueError(f"state must be contiguous i32[{rows}, w]")


def _check_packed(scene: FastScene, sf: torch.Tensor,
                  si: torch.Tensor) -> None:
    _check_scene(scene, sf.device)
    _check_table(scene, "nodes8", 8, sf.device)
    if (sf.dtype != torch.float32 or sf.dim() != 2
            or sf.shape[0] != SF_ROWS or not sf.is_contiguous()):
        raise ValueError("sf must be contiguous f32[13, w]")
    if (si.dtype != torch.int32 or si.dim() != 2 or si.shape[0] < 1
            or si.shape[1] != sf.shape[1] or si.device != sf.device
            or not si.is_contiguous()):
        raise ValueError("si must be contiguous i32[k, w] beside sf")


def _launch_rounds(name: str, scene: FastScene, state: torch.Tensor,
                   bcap: int, sky_on: bool, cfg: RenderConfig,
                   key_mode: str = "cid", ordered: bool = True):
    w = state.shape[1]
    out = torch.empty_like(state)
    key = torch.empty(w, dtype=torch.int32, device=state.device)
    # (rays, live), then the ray counter of the pmega call's persistent
    # warps (bounce15 at bcap > 1).
    counts = torch.zeros(3, dtype=torch.int64, device=state.device)
    lib = cuda_build.library(scene.layout)
    stream = torch.cuda.current_stream(state.device).cuda_stream
    cuda_build.check(getattr(lib, f"rt_{name}")(
        scene.nodes4.data_ptr(), scene.clusters.data_ptr(),
        scene.nodes8.data_ptr(), state.data_ptr(), out.data_ptr(),
        key.data_ptr(), counts.data_ptr(), w, int(bcap), int(bool(sky_on)),
        cfg.fuzz, int(cfg.emissive_emits), cfg.t_min, cfg.t_max, cfg.det_eps,
        KERNEL_KEYS.index(key_mode), int(bool(ordered)), stream),
        f"rt_{name}")
    launches.kernel[build_name(name, key_mode, ordered, scene.layout)] += 1
    return out, key, counts[:2]


def _on_cuda(t: torch.Tensor) -> bool:
    """False for a CPU tensor (plain version), True for a CUDA one,
    raises for any other device."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type == "cuda"


def bounce12(scene: FastScene, state: torch.Tensor, bcap: int, sky_on: bool,
             cfg: RenderConfig, key_mode: str = "cid", ordered: bool = True):
    """Kernel B on CUDA tensors, its plain version on CPU tensors (same
    arguments and results as ``bounce12_plain``)."""
    if not _on_cuda(state):
        return bounce12_plain(scene, state, bcap, sky_on, cfg, key_mode,
                              ordered)
    _check_state(scene, state, STATE_ROWS)
    return _launch_rounds("bounce12", scene, state, bcap, sky_on, cfg,
                          key_mode, ordered)


def bounce15(scene: FastScene, state: torch.Tensor, bcap: int, sky_on: bool,
             cfg: RenderConfig, key_mode: str = "cid", ordered: bool = True):
    """The colour-carrying kernel on CUDA tensors, its plain version on
    CPU tensors (same arguments and results as ``bounce15_plain``)."""
    if not _on_cuda(state):
        return bounce15_plain(scene, state, bcap, sky_on, cfg, key_mode,
                              ordered)
    _check_state(scene, state, COLOR_ROWS)
    return _launch_rounds("bounce15", scene, state, bcap, sky_on, cfg,
                          key_mode, ordered)


def _launch_packed(name: str, scene: FastScene, sf: torch.Tensor,
                   si: torch.Tensor, bcap: int, sky_on: bool,
                   cfg: RenderConfig, *extra: torch.Tensor,
                   key_mode: str = "cid"):
    w = sf.shape[1]
    sf_out = torch.empty_like(sf)
    si_out = torch.empty_like(si)
    key = torch.empty(w, dtype=torch.int32, device=sf.device)
    counts = torch.zeros(2, dtype=torch.int64, device=sf.device)
    lib = cuda_build.library(scene.layout)
    stream = torch.cuda.current_stream(sf.device).cuda_stream
    # The counting build has the cid key only and takes no key code.
    code = () if extra else (KERNEL_KEYS.index(key_mode),)
    cuda_build.check(getattr(lib, f"rt_{name}")(
        scene.nodes4.data_ptr(), scene.clusters.data_ptr(),
        scene.nodes8.data_ptr(), sf.data_ptr(), si.data_ptr(),
        sf_out.data_ptr(), si_out.data_ptr(), key.data_ptr(),
        counts.data_ptr(), *(t.data_ptr() for t in extra), w, si.shape[0],
        int(bcap), int(bool(sky_on)), cfg.fuzz, int(cfg.emissive_emits),
        cfg.t_min, cfg.t_max, cfg.det_eps, *code, stream), f"rt_{name}")
    launches.kernel[build_name(name, key_mode, layout=scene.layout)] += 1
    return sf_out, si_out, key, counts


def bounce_packed(scene: FastScene, sf: torch.Tensor, si: torch.Tensor,
                  bcap: int, sky_on: bool, cfg: RenderConfig,
                  key_mode: str = "cid"):
    """The packed kernel on CUDA tensors, its plain version on CPU tensors
    (same arguments and results as ``bounce_packed_plain``)."""
    if not _on_cuda(sf):
        return bounce_packed_plain(scene, sf, si, bcap, sky_on, cfg,
                                   key_mode)
    _check_packed(scene, sf, si)
    return _launch_packed("bounce_packed", scene, sf, si, bcap, sky_on, cfg,
                          key_mode=key_mode)


def bounce_packed_count(scene: FastScene, sf: torch.Tensor,
                        si: torch.Tensor, bcap: int, sky_on: bool,
                        cfg: RenderConfig):
    """The counting build of the packed kernel (CUDA tensors only): the
    results of ``bounce_packed``, then the walk's tallies int64[4] (visit
    trips, lanes active in them, leaf trips, lanes active in them, summed
    over warps) and each launched block's first and last ``%globaltimer``
    reading, int64[blocks, 2] in ns."""
    if not _on_cuda(sf):
        raise ValueError("the counting build runs on the card only")
    _check_packed(scene, sf, si)
    tallies = torch.zeros(4, dtype=torch.int64, device=sf.device)
    times = torch.zeros((-(-sf.shape[1] // 128), 2), dtype=torch.int64,
                        device=sf.device)
    out = _launch_packed("bounce_packed_count", scene, sf, si, bcap, sky_on,
                         cfg, tallies, times)
    return (*out, tallies, times[times[:, 0] != 0])
