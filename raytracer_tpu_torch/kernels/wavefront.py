"""Sorted-wavefront bounce rounds and the cross-band tail.

The port of the JAX package's bounce engines
(``raytracer_tpu/kernels/wavefront.py``, ``RAYTPU_SORT_KEY=cid``,
``RAYTPU_GLUE=one``): each round is a stable argsort of the carried key,
one gather of the whole round state and one round of walk + shade. Levels
shrink by static slice (``round_widths``); each shrink's dead tail
deposits its colour and is dropped. With a handoff width, the band stops
there and hands its survivors to ``wavefront_tail``, which runs the deep
rounds once over all bands with per-ray bounce budgets.

The round engine is ``RAYTPU_WAVE`` (``raytracer_tpu_torch/knobs.py``):

* ``fused12`` (default): kernel B (``bounce12``) with the no-color carry,
  state i32[13, w];
* ``fused``: the colour-carrying kernel (``bounce15``), state i32[16, w];
* ``fused_packed``: the packed kernel (``bounce_packed``) over the pair
  (sf f32[13, w], si i32[2, w]), each gathered along the ray axis; its
  survivors hand off as colour-carrying i32[16, w] state;
* ``split``: ``trace.traverse`` (kernel A or 5 by the knobs) and the plain
  ``tracer.shade`` each round, colour carried, ``rays`` counted before the
  round and the key recomputed on the host as u32 ``om9`` with the dead
  bit at 31 (the fused engines carry the kernel's i32 key, dead bit 30).

Python loops replace ``lax.while_loop``: a round's live count is read on
the host (one sync per round) to decide the next step, as the JAX loop
condition does on the device.

Deposits: every ray deposits exactly once, so the colour buffers are
filled with ``index_add_`` onto zeros (exact in any order). Pad rays carry
a pixel id at or past the buffer size; their deposits land in one spare
cell that is sliced away (``mode="drop"`` in the JAX version).
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch import knobs
from raytracer_tpu_torch.core.fast_types import FastScene
from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.kernels.bounce import (ROW_ALIVE, ROW_BUDGET,
                                                ROW_PIX, ROW_SEED,
                                                STATE_ROWS, UNIFORM_BUDGET,
                                                bounce12, bounce15,
                                                bounce_packed, pack_state,
                                                packed_to_state,
                                                unpack_floats)
from raytracer_tpu_torch.kernels.rng import M32
from raytracer_tpu_torch.kernels.trace import BBLOCK, traverse
from raytracer_tpu_torch.kernels.tracer import shade

# Narrowest sorted-round width (4 bounce tiles).
MIN_WIDTH = 4 * BBLOCK


def _part1by2(v):
    """Spread the low 10 bits of v to every 3rd bit."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def sort_key(ray_o, ray_d, alive, smin, smax,
             dead_bit: int = 31) -> torch.Tensor:
    """Round key as u32 values in int64: dead flag at ``dead_bit``, then
    morton9(origin) << 3 | direction octant. Bit-equal to the JAX
    ``sort_key`` in its ``om9`` mode, which is also the host-side form of
    the default ``cid`` key (the fused kernels emit the cid form
    themselves)."""
    dead = (~alive).to(torch.int64) << dead_bit
    morton = torch.zeros_like(dead)
    for ax in range(3):
        span = torch.clamp_min(smax[ax] - smin[ax], 1e-6)
        q = torch.clamp((ray_o[ax] - smin[ax]) / span * 511.0, 0.0, 511.0)
        morton = morton | (_part1by2(q.to(torch.int64)) << ax)
    octant = ((ray_d[0] > 0).to(torch.int64)
              | ((ray_d[1] > 0).to(torch.int64) << 1)
              | ((ray_d[2] > 0).to(torch.int64) << 2))
    morton = morton & ((1 << 27) - 1)
    return dead | (morton << 3) | octant


def round_widths(p: int) -> list[int]:
    """Level schedule p, ~p/2, ~p/4, ... floored at MIN_WIDTH, each a
    whole number of BBLOCK tiles."""
    knobs.fixed("RAYTPU_WAVE_MINW", "RAYTPU_WAVE_BCAP", "RAYTPU_TAIL_BCAP",
                "RAYTPU_ORDER_MINW", "RAYTPU_DEEP_SUB", "RAYTPU_DEEP_MAXW")
    widths = [p]
    while True:
        nxt = (widths[-1] // 2 // BBLOCK) * BBLOCK
        if nxt < MIN_WIDTH:
            break
        widths.append(nxt)
    return widths


# A round state is one i32 tensor (``kernels/bounce.py`` layouts) or, for
# the fused_packed engine, the pair (sf, si). These helpers take either.

def _alive(state) -> torch.Tensor:
    if isinstance(state, tuple):
        return state[0][12] > 0.5
    return state[ROW_ALIVE] != 0


def _state_key(state, scene: FastScene, engine: str = "fused12"):
    """Host-side key of a round state: the kernels' i32 cid form (dead bit
    30) for the fused engines, u32 values in int64 (dead bit 31) for the
    split engine."""
    if isinstance(state, tuple):
        f = state[0]
        o, d = (f[0], f[1], f[2]), (f[3], f[4], f[5])
    else:
        o, d, _, _ = unpack_floats(state)
    smin, smax = scene.bounds()
    if engine == "split":
        return sort_key(o, d, _alive(state), smin, smax)
    return sort_key(o, d, _alive(state), smin, smax,
                    dead_bit=30).to(torch.int32)


def _deposits(state) -> torch.Tensor:
    """f32[3, w] colour deposits: the colour rows when the colour is
    carried; without it, dead rays' atten rows (live rays deposit black:
    the bounce cap's kill-to-black)."""
    if isinstance(state, tuple):
        return state[0][6:9]
    f = state[6:9].view(torch.float32)
    if state.shape[0] != STATE_ROWS:
        return f
    return torch.where(_alive(state), 0.0, f)


def _deposit(out: torch.Tensor, state) -> None:
    """Add a state's deposits into out f32[3, n + 1] at its pixel ids
    (ids >= n go to the spare cell n). In place."""
    n = out.shape[1] - 1
    pix = state[1][1] if isinstance(state, tuple) else state[ROW_PIX]
    out.index_add_(1, torch.clamp(pix, max=n).to(torch.int64),
                   _deposits(state))


def _sorted(state, key):
    """Stable sort of the state by key -> (state, key)."""
    order = torch.argsort(key, stable=True)
    if isinstance(state, tuple):
        state = tuple(x.index_select(1, order) for x in state)
    else:
        state = state.index_select(1, order)
    return state, key.index_select(0, order)


def _prefix(state, n: int):
    if isinstance(state, tuple):
        return tuple(x[:, :n].contiguous() for x in state)
    return state[:, :n].contiguous()


class _Ladder:
    """Shared round/shrink loop of the band wavefront and the tail."""

    def __init__(self, scene: FastScene, sky_on: bool, cfg: RenderConfig,
                 out: torch.Tensor, engine: str):
        self.scene, self.sky_on, self.cfg, self.out = scene, sky_on, cfg, out
        self.engine = engine
        self.rays = torch.zeros((), dtype=torch.int64, device=out.device)

    def round(self, state, key):
        """One sorted round -> (state, key, live)."""
        state, _ = _sorted(state, key)
        if self.engine == "split":
            return self._split_round(state)
        args = (1, self.sky_on, self.cfg)
        if self.engine == "fused_packed":
            sf, si, key, counts = bounce_packed(self.scene, *state, *args)
            state = (sf, si)
        else:
            kernel = bounce12 if self.engine == "fused12" else bounce15
            state, key, counts = kernel(self.scene, state, *args)
        self.rays = self.rays + counts[0]
        return state, key, int(counts[1])

    def _split_round(self, state):
        o, d, c, a = unpack_floats(state)
        alive = _alive(state)
        self.rays = self.rays + alive.sum()
        res = traverse(self.scene, o, d, alive, self.cfg)
        seed = state[ROW_SEED].to(torch.int64) & M32
        o, d, c, a, seed, alive = shade(res, o, d, c, a, seed, alive,
                                        self.sky_on, self.cfg)
        state = pack_state(o, d, a, seed, alive, state[ROW_BUDGET],
                           state[ROW_PIX], color=c)
        return (state, _state_key(state, self.scene, "split"),
                int(alive.sum()))

    def shrink(self, state, key, next_width: int):
        """Sort, deposit the tail past next_width, keep the prefix."""
        state, key = _sorted(state, key)
        tail = (tuple(x[:, next_width:] for x in state)
                if isinstance(state, tuple) else state[:, next_width:])
        _deposit(self.out, tail)
        return _prefix(state, next_width), key[:next_width]


def wavefront_bounces(scene: FastScene, ray_o, ray_d, color, atten, seed,
                      alive, sky_on: bool, cfg: RenderConfig, pix,
                      handoff_width: int | None = None,
                      start_bounce: int = 1):
    """Sorted bounce rounds ``start_bounce``.. over flat [P] SoA state (P a
    multiple of BBLOCK), on the engine ``knobs.wave_engine()``: from
    bounce 1 after the bounce-0 shade, or from bounce 0 on unshaded
    primaries (``RAYTPU_B0=pwave``: the first round's key is computed from
    them, and the rounds' rays include bounce 0's). ``pix``: each ray's
    deposit cell, pads >= P.

    Returns (color f32[3, P], rays traced (int64 tensor), survivors):
    ``survivors`` is None, or with ``handoff_width`` the round state
    (i32[13, width] for fused12, else i32[16, width]) of the live-sorted
    band tail with per-ray bounces-left budgets (their pixels hold 0 in
    ``color``)."""
    p = alive.shape[0]
    if p % BBLOCK:
        raise ValueError(f"ray count {p} not a multiple of {BBLOCK}")
    engine = knobs.wave_engine()
    knobs.fixed("RAYTPU_SORT_KEY", "RAYTPU_GLUE", "RAYTPU_DEPOSIT")
    if engine == "fused_packed":
        knobs.fixed("RAYTPU_PACK_GATHER")
    if handoff_width is not None and engine == "split":
        raise ValueError("tail handoff requires a fused wavefront path")
    if engine == "fused12":
        # No-color carry: dead entrants' colours (their deposits) ride in
        # the atten rows; live entrants' colours are necessarily 0.
        atten = tuple(torch.where(alive, a, c) for a, c in zip(atten, color))
        state = pack_state(ray_o, ray_d, atten, seed, alive, UNIFORM_BUDGET,
                           pix)
    elif engine == "fused_packed":
        state = (torch.stack([*ray_o, *ray_d, *color, *atten,
                              alive.to(torch.float32)]),
                 torch.stack([seed.to(torch.int32), pix.to(torch.int32)]))
    else:
        state = pack_state(ray_o, ray_d, atten, seed, alive, UNIFORM_BUDGET,
                           pix, color=color)
    key = _state_key(state, scene, engine)
    out = torch.zeros((3, p + 1), dtype=torch.float32, device=alive.device)
    lad = _Ladder(scene, sky_on, cfg, out, engine)
    bounce = start_bounce
    widths = round_widths(p)
    for li, width in enumerate(widths):
        if handoff_width is not None and width <= handoff_width:
            budget = cfg.max_bounces - bounce
            if isinstance(state, tuple):
                state = packed_to_state(*state, budget, state[1][1])
            else:
                state[ROW_BUDGET] = budget
            return out[:, :p], lad.rays, state
        is_last = li == len(widths) - 1
        next_width = None if is_last else widths[li + 1]
        live = int(_alive(state).sum())
        while (bounce < cfg.max_bounces and live > 0
               and (is_last or live > next_width)):
            state, key, live = lad.round(state, key)
            bounce += 1
        if is_last:
            _deposit(out, state)
            break
        state, key = lad.shrink(state, key, next_width)
    return out[:, :p], lad.rays, None


def wavefront_tail(scene: FastScene, state: torch.Tensor, sky_on: bool,
                   cfg: RenderConfig, out_size: int):
    """Deep rounds over the merged band survivors (round state with global
    pixel ids, pads >= out_size, and per-ray budgets). A ray is alive only
    while its budget is > 0: rays handed off at their bounce cap die there,
    black without the colour carry, keeping their colour with it. Returns
    (color f32[3, out_size], rays traced)."""
    knobs.fixed("RAYTPU_SORT_KEY", "RAYTPU_GLUE", "RAYTPU_DEPOSIT")
    alive = state[ROW_ALIVE] != 0
    kill = alive & (state[ROW_BUDGET] <= 0)
    nocolor = state.shape[0] == STATE_ROWS
    if nocolor:
        f = state[6:9].view(torch.float32)
        f.copy_(torch.where(kill, 0.0, f))
    state[ROW_ALIVE] = (alive & ~kill).to(torch.int32)
    key = _state_key(state, scene)
    out = torch.zeros((3, out_size + 1), dtype=torch.float32,
                      device=state.device)
    lad = _Ladder(scene, sky_on, cfg, out, "fused12" if nocolor else "fused")
    widths = round_widths(state.shape[1])
    for li, width in enumerate(widths):
        is_last = li == len(widths) - 1
        next_width = None if is_last else widths[li + 1]
        live = int(_alive(state).sum())
        while live > (0 if is_last else next_width):
            state, key, live = lad.round(state, key)
        if is_last:
            _deposit(out, state)
            break
        state, key = lad.shrink(state, key, next_width)
    return out[:, :out_size], lad.rays
