"""Sorted-wavefront bounce rounds and the cross-band tail.

The port of the JAX package's default bounce engine
(``raytracer_tpu/kernels/wavefront.py``, ``RAYTPU_WAVE=fused12``,
``RAYTPU_SORT_KEY=cid``, ``RAYTPU_GLUE=one``, graveyard deposits): each
round is a stable argsort of the carried i32 key, one gather of the whole
round state (``kernels/bounce.py`` layout) and one kernel B call, which
emits the next round's key. Levels shrink by static slice
(``round_widths``); each shrink's dead tail deposits its colour and is
dropped. With a handoff width, the band stops there and hands its
survivors to ``wavefront_tail``, which runs the deep rounds once over all
bands with per-ray bounce budgets.

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

from raytracer_tpu_torch.core.fast_types import FastScene
from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.kernels.bounce import (ROW_ALIVE, ROW_BUDGET,
                                                ROW_PIX, UNIFORM_BUDGET,
                                                bounce12, pack_state,
                                                unpack_floats)
from raytracer_tpu_torch.kernels.trace import BBLOCK

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
    the default ``cid`` key (kernel B emits the cid form itself)."""
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
    widths = [p]
    while True:
        nxt = (widths[-1] // 2 // BBLOCK) * BBLOCK
        if nxt < MIN_WIDTH:
            break
        widths.append(nxt)
    return widths


def _state_key(state, scene: FastScene):
    """Host-side cid key (dead bit 30, i32) of a round state."""
    o, d, _ = unpack_floats(state)
    smin, smax = scene.bounds()
    return sort_key(o, d, state[ROW_ALIVE] != 0, smin, smax,
                    dead_bit=30).to(torch.int32)


def _deposits(state):
    """Dead rays' atten rows are their colour; live rays deposit black
    (the bounce cap's kill-to-black)."""
    _, _, a = unpack_floats(state)
    alive = state[ROW_ALIVE] != 0
    return torch.stack([torch.where(alive, 0.0, c) for c in a])


def _deposit(out: torch.Tensor, state) -> None:
    """Add a state's deposits into out f32[3, n + 1] at its pixel ids
    (ids >= n go to the spare cell n). In place."""
    n = out.shape[1] - 1
    pix = torch.clamp(state[ROW_PIX], max=n).to(torch.int64)
    out.index_add_(1, pix, _deposits(state))


def _sorted(state, key):
    """Stable sort of the state by key -> (state, key)."""
    order = torch.argsort(key, stable=True)
    return state.index_select(1, order), key.index_select(0, order)


class _Ladder:
    """Shared round/shrink loop of the band wavefront and the tail."""

    def __init__(self, scene: FastScene, sky_on: bool, cfg: RenderConfig,
                 out: torch.Tensor):
        self.scene, self.sky_on, self.cfg, self.out = scene, sky_on, cfg, out
        self.rays = torch.zeros((), dtype=torch.int64, device=out.device)

    def round(self, state, key):
        """One sorted round -> (state, key, live)."""
        state, _ = _sorted(state, key)
        state, key, counts = bounce12(self.scene, state, 1, self.sky_on,
                                      self.cfg)
        self.rays = self.rays + counts[0]
        return state, key, int(counts[1])

    def shrink(self, state, key, next_width: int):
        """Sort, deposit the tail past next_width, keep the prefix."""
        state, key = _sorted(state, key)
        _deposit(self.out, state[:, next_width:])
        return state[:, :next_width].contiguous(), key[:next_width]


def wavefront_bounces(scene: FastScene, ray_o, ray_d, color, atten, seed,
                      alive, sky_on: bool, cfg: RenderConfig, pix,
                      handoff_width: int | None = None):
    """Sorted bounce rounds 1.. over flat [P] SoA state after bounce 0
    (P a multiple of BBLOCK). ``pix``: each ray's deposit cell, pads >= P.

    Returns (color f32[3, P], rays traced (int64 tensor), survivors):
    ``survivors`` is None, or with ``handoff_width`` the round state
    i32[13, width] of the live-sorted band tail with per-ray bounces-left
    budgets (their pixels hold 0 in ``color``)."""
    p = alive.shape[0]
    if p % BBLOCK:
        raise ValueError(f"ray count {p} not a multiple of {BBLOCK}")
    # No-color carry: dead entrants' colours (their deposits) ride in the
    # atten rows; live entrants' colours are necessarily 0.
    atten = tuple(torch.where(alive, a, c) for a, c in zip(atten, color))
    state = pack_state(ray_o, ray_d, atten, seed, alive, UNIFORM_BUDGET, pix)
    key = _state_key(state, scene)
    out = torch.zeros((3, p + 1), dtype=torch.float32, device=alive.device)
    lad = _Ladder(scene, sky_on, cfg, out)
    bounce = 1
    widths = round_widths(p)
    for li, width in enumerate(widths):
        if handoff_width is not None and width <= handoff_width:
            state[ROW_BUDGET] = cfg.max_bounces - bounce
            return out[:, :p], lad.rays, state
        is_last = li == len(widths) - 1
        next_width = None if is_last else widths[li + 1]
        live = int((state[ROW_ALIVE] != 0).sum())
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
    """Deep rounds over the merged band survivors (i32[13, w] with global
    pixel ids, pads >= out_size, and per-ray budgets). Rays handed off at
    their bounce cap (budget 0) die black. Returns (color f32[3,
    out_size], rays traced)."""
    alive = state[ROW_ALIVE] != 0
    kill = alive & (state[ROW_BUDGET] <= 0)
    f = state[6:9].view(torch.float32)
    f.copy_(torch.where(kill, 0.0, f))
    state[ROW_ALIVE] = (alive & ~kill).to(torch.int32)
    key = _state_key(state, scene)
    out = torch.zeros((3, out_size + 1), dtype=torch.float32,
                      device=state.device)
    lad = _Ladder(scene, sky_on, cfg, out)
    widths = round_widths(state.shape[1])
    for li, width in enumerate(widths):
        is_last = li == len(widths) - 1
        next_width = None if is_last else widths[li + 1]
        live = int((state[ROW_ALIVE] != 0).sum())
        while live > (0 if is_last else next_width):
            state, key, live = lad.round(state, key)
        if is_last:
            _deposit(out, state)
            break
        state, key = lad.shrink(state, key, next_width)
    return out[:, :out_size], lad.rays
