"""Sorted-wavefront bounce rounds and the cross-band tail.

The port of the JAX package's bounce engines
(``raytracer_tpu/kernels/wavefront.py``): each round is a stable argsort
of the carried key, a gather of the round state and one round of walk +
shade. Levels shrink by static slice (``round_widths``); each shrink's dead
tail deposits its colour and is dropped. With a handoff width, the band
stops there and hands its survivors to ``wavefront_tail``, which runs the
deep rounds once over all bands with per-ray bounce budgets.

The round engine is ``RAYTPU_WAVE`` (``raytracer_tpu_torch/knobs.py``):

* ``fused12`` (default): kernel B (``bounce12``) with the no-color carry,
  state i32[13, w];
* ``fused``: the colour-carrying kernel (``bounce15``), state i32[16, w];
* ``fused_packed``: the packed kernel (``bounce_packed``) over the pair
  (sf f32[13, w], si i32[2, w]), each gathered along the ray axis; its
  survivors hand off as colour-carrying i32[16, w] state;
* ``split``: ``trace.traverse`` (kernel A or 5 by the knobs) and the plain
  ``tracer.shade`` each round, colour carried, ``rays`` counted before the
  round and the key recomputed on the host; also the engine of every
  scene without a wide table, whatever the knob (JAX ``has4``,
  ``wavefront.py:347``).

The A/B knobs of the rounds, each read at call time (``knobs.py``):

* ``RAYTPU_SORT_KEY``: the fused engines carry the key kernel B emits for
  ``cid``, ``pd5`` and ``om9`` (i32, dead bit 30); for any other mode,
  and on the split engine, the host recomputes the u32 key (int64, dead
  bit 31) after every round (``kernels/keys.py``);
* ``RAYTPU_GLUE``: the band rounds' gather (``_gather``); the tail and
  every shrink gather the whole state at once, as in the JAX package;
* ``RAYTPU_DEPOSIT``: ``_Deposits``;
* ``RAYTPU_PACK_GATHER``: the packed engine's gathers;
* the level schedule: ``round_widths`` (``RAYTPU_WAVE_MINW``,
  ``RAYTPU_DEEP_SUB``), bounces a round (``RAYTPU_WAVE_BCAP`` on the fused
  band rounds, ``RAYTPU_TAIL_BCAP`` in the tail, where the per-ray budget
  keeps the result that of one-bounce rounds) and unordered walks on
  levels narrower than ``RAYTPU_ORDER_MINW`` (``bounce12`` and
  ``bounce15`` rounds of the band and the tail; never the packed engine).

Python loops replace ``lax.while_loop``: a round's live count is read on
the host (one sync per round) to decide the next step, as the JAX loop
condition does on the device.
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
from raytracer_tpu_torch.kernels.keys import KERNEL_KEYS, sort_key
from raytracer_tpu_torch.kernels.rng import M32
from raytracer_tpu_torch.kernels.trace import BBLOCK, BLOCK_LANES, traverse
from raytracer_tpu_torch.kernels.tracer import shade

# Narrowest sorted-round width (4 bounce tiles) when RAYTPU_WAVE_MINW is
# unset.
MIN_WIDTH = 4 * BBLOCK


def min_width() -> int:
    """``RAYTPU_WAVE_MINW`` rounded up to whole BBLOCK tiles (at least
    one), or ``MIN_WIDTH`` when unset."""
    minw = knobs.wave_minw()
    if minw is None:
        return MIN_WIDTH
    return max(1, -(-minw // BBLOCK)) * BBLOCK


def round_widths(p: int) -> list[int]:
    """Level schedule p, ~p/2, ~p/4, ... floored at ``min_width()``, each
    a whole number of BBLOCK tiles, or of ``RAYTPU_DEEP_SUB * 128``-ray
    tiles when that is coarser."""
    deep_sub, _ = knobs.deep_grain()
    grain = max(BBLOCK, deep_sub * BLOCK_LANES if deep_sub else 0)
    floor = min_width()
    widths = [p]
    while True:
        nxt = (widths[-1] // 2 // grain) * grain
        if nxt < floor:
            break
        widths.append(nxt)
    return widths


# A round state is one i32 tensor (``kernels/bounce.py`` layouts) or, for
# the fused_packed engine, the pair (sf, si). These helpers take either.

def _alive(state) -> torch.Tensor:
    if isinstance(state, tuple):
        return state[0][12] > 0.5
    return state[ROW_ALIVE] != 0


def _kernel_key(engine: str, mode: str) -> bool:
    """True where the rounds carry kernel B's key (the JAX ``kernel_key``
    rule: a fused engine and a key the kernel emits)."""
    return engine != "split" and mode in KERNEL_KEYS


def _state_key(state, scene: FastScene, engine: str = "fused12",
               mode: str = "cid"):
    """Host-side key of a round state: i32 with the dead bit at 30 where
    the rounds carry kernel B's key, else u32 values in int64 with the
    dead bit at 31."""
    if isinstance(state, tuple):
        f = state[0]
        o, d = (f[0], f[1], f[2]), (f[3], f[4], f[5])
    else:
        o, d, _, _ = unpack_floats(state)
    smin, smax = scene.bounds()
    if _kernel_key(engine, mode):
        return sort_key(o, d, _alive(state), smin, smax, mode,
                        dead_bit=30).to(torch.int32)
    return sort_key(o, d, _alive(state), smin, smax, mode)


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


def _pix(state) -> torch.Tensor:
    return state[1][1] if isinstance(state, tuple) else state[ROW_PIX]


class _Deposits:
    """Colour deposits into ``n`` cells; a pixel id >= n is a pad's and
    lands nowhere (``mode="drop"`` in the JAX version). Every ray deposits
    exactly once, so the adds onto zeros are exact in any order. Modes
    (``RAYTPU_DEPOSIT``):

    * ``grave``: no adds; each deposit appends (pixel id, colour bits) rows
      i32[m, 4] to a graveyard, and ``colors`` sorts them by pixel id
      (one stable argsort and one row gather). Only under the dense-pixel
      promise of a band: each id < n at most once (a gather keeps a -0.0
      deposit, which an add onto zeros turns into +0.0);
    * ``rows``: one add of [m, 3] rows into f32[n + 1, 3];
    * ``ch``: one add a channel into f32[3, n + 1]."""

    def __init__(self, n: int, device, mode: str):
        self.n, self.mode = n, mode
        if mode == "grave":
            self.grave = []
        elif mode == "rows":
            self.out = torch.zeros((n + 1, 3), dtype=torch.float32,
                                   device=device)
        else:
            self.out = torch.zeros((3, n + 1), dtype=torch.float32,
                                   device=device)

    def add(self, pix: torch.Tensor, dep: torch.Tensor) -> None:
        """Deposit dep f32[3, m] at pixel ids pix i32[m]."""
        if self.mode == "grave":
            bits = dep.view(torch.int32)
            self.grave.append(torch.stack([pix, bits[0], bits[1], bits[2]],
                                          dim=1))
            return
        idx = torch.clamp(pix, max=self.n).to(torch.int64)
        if self.mode == "rows":
            self.out.index_add_(0, idx, dep.T)
        else:
            for c in range(3):
                self.out[c].index_add_(0, idx, dep[c])

    def add_state(self, state) -> None:
        self.add(_pix(state), _deposits(state))

    def colors(self) -> torch.Tensor:
        """f32[3, n]: the cells (graveyard: the first n rows in pixel id
        order, the pads' after every real pixel)."""
        if self.mode == "grave":
            g = torch.cat(self.grave)
            g = g.index_select(0, torch.argsort(g[:, 0], stable=True))
            return g[:self.n, 1:4].T.contiguous().view(torch.float32)
        if self.mode == "rows":
            return self.out[:self.n].T.contiguous()
        return self.out[:, :self.n]


def _deposit_mode(dense_pix: bool) -> str:
    """The JAX rule: the graveyard under a band's dense-pixel promise and
    ``RAYTPU_DEPOSIT=grave``, rows for ``rows``, else per channel."""
    mode = knobs.deposit()
    if mode == "grave":
        return "grave" if dense_pix else "ch"
    return "rows" if mode == "rows" else "ch"


def _gather(state, order: torch.Tensor, glue: str = "one",
            gather: str = "col"):
    """The round state reordered by ``order``, as the glue mode moves it.
    Packed pairs: each gathered along the ray axis (``gather`` "col"), or
    transposed, row-gathered and transposed back ("row"). Flat states
    (``RAYTPU_GLUE``): one gather ("one"), one a row ("perfield"), a row
    gather of the transposed state ("packT"), or the f32 rows and the i32
    rows apart (any other value)."""
    if isinstance(state, tuple):
        if gather == "row":
            return tuple(x.T.contiguous().index_select(0, order).T
                         .contiguous() for x in state)
        return tuple(x.index_select(1, order) for x in state)
    if glue == "one":
        return state.index_select(1, order)
    if glue == "perfield":
        out = torch.empty_like(state)
        for r in range(state.shape[0]):
            torch.index_select(state[r], 0, order, out=out[r])
        return out
    if glue == "packT":
        return state.T.contiguous().index_select(0, order).T.contiguous()
    nf = state.shape[0] - 4
    return torch.cat([state[:nf].index_select(1, order),
                      state[nf:].index_select(1, order)])


def _sorted(state, key, gather: str = "col"):
    """Stable sort of the state by key -> (state, key)."""
    order = torch.argsort(key, stable=True)
    return _gather(state, order, gather=gather), key.index_select(0, order)


def _prefix(state, n: int):
    if isinstance(state, tuple):
        return tuple(x[:, :n].contiguous() for x in state)
    return state[:, :n].contiguous()


def _ordered(width: int) -> bool:
    """Whether a level of ``width`` rays walks near-first
    (``RAYTPU_ORDER_MINW``)."""
    order_minw = knobs.order_minw()
    return order_minw == 0 or width >= order_minw


class _Ladder:
    """Shared round/shrink loop of the band wavefront and the tail."""

    def __init__(self, scene: FastScene, sky_on: bool, cfg: RenderConfig,
                 deposits: _Deposits, engine: str, mode: str,
                 glue: str = "one", gather: str = "col"):
        self.scene, self.sky_on, self.cfg = scene, sky_on, cfg
        self.deposits, self.engine, self.mode = deposits, engine, mode
        self.glue, self.gather = glue, gather
        self.kernel_key = _kernel_key(engine, mode)
        # The build launched: the key's own where the rounds carry it,
        # else the default (its key is not read).
        self.build_key = mode if self.kernel_key else "cid"
        self.rays = torch.zeros((), dtype=torch.int64,
                                device=scene.device)

    def round(self, state, key, cap: int = 1, ordered: bool = True):
        """One sorted round of up to ``cap`` bounces -> (state, key,
        live)."""
        order = torch.argsort(key, stable=True)
        state = _gather(state, order, self.glue, self.gather)
        if self.engine == "split":
            return self._split_round(state)
        args = (cap, self.sky_on, self.cfg)
        if self.engine == "fused_packed":
            sf, si, kkey, counts = bounce_packed(self.scene, *state, *args,
                                                 key_mode=self.build_key)
            state = (sf, si)
        else:
            kernel = bounce12 if self.engine == "fused12" else bounce15
            state, kkey, counts = kernel(self.scene, state, *args,
                                         key_mode=self.build_key,
                                         ordered=ordered)
        self.rays = self.rays + counts[0]
        if not self.kernel_key:
            kkey = _state_key(state, self.scene, self.engine, self.mode)
        return state, kkey, int(counts[1])

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
        return (state, _state_key(state, self.scene, "split", self.mode),
                int(alive.sum()))

    def shrink(self, state, key, next_width: int):
        """Sort, deposit the tail past next_width, keep the prefix."""
        state, key = _sorted(state, key, self.gather)
        tail = (tuple(x[:, next_width:] for x in state)
                if isinstance(state, tuple) else state[:, next_width:])
        self.deposits.add_state(tail)
        return _prefix(state, next_width), key[:next_width]


def wavefront_bounces(scene: FastScene, ray_o, ray_d, color, atten, seed,
                      alive, sky_on: bool, cfg: RenderConfig, pix,
                      handoff_width: int | None = None,
                      start_bounce: int = 1, dense_pix: bool = False):
    """Sorted bounce rounds ``start_bounce``.. over flat [P] SoA state (P a
    multiple of BBLOCK), on the engine ``knobs.wave_engine()``: from
    bounce 1 after the bounce-0 shade, or from bounce 0 on unshaded
    primaries (``RAYTPU_B0=pwave``: the first round's key is computed from
    them, and the rounds' rays include bounce 0's). ``pix``: each ray's
    deposit cell, pads >= P. ``dense_pix``: the caller promises each id
    < P at most once (a band at one sample), which lets
    ``RAYTPU_DEPOSIT=grave`` deposit by graveyard.

    Returns (color f32[3, P], rays traced (int64 tensor), survivors):
    ``survivors`` is None, or with ``handoff_width`` the round state
    (i32[13, width] for fused12, else i32[16, width]) of the live-sorted
    band tail with per-ray bounces-left budgets (their pixels hold 0 in
    ``color``)."""
    p = alive.shape[0]
    if p % BBLOCK:
        raise ValueError(f"ray count {p} not a multiple of {BBLOCK}")
    engine = knobs.wave_engine() if scene.nodes4 is not None else "split"
    mode = knobs.sort_key_mode()
    packed = engine == "fused_packed"
    glue = "one" if packed else knobs.glue(engine)
    gather = knobs.pack_gather() if packed else "col"
    if handoff_width is not None and engine == "split":
        raise ValueError("tail handoff requires a fused wavefront path")
    if engine == "fused12":
        # No-color carry: dead entrants' colours (their deposits) ride in
        # the atten rows; live entrants' colours are necessarily 0.
        atten = tuple(torch.where(alive, a, c) for a, c in zip(atten, color))
        state = pack_state(ray_o, ray_d, atten, seed, alive, UNIFORM_BUDGET,
                           pix)
    elif packed:
        state = (torch.stack([*ray_o, *ray_d, *color, *atten,
                              alive.to(torch.float32)]),
                 torch.stack([seed.to(torch.int32), pix.to(torch.int32)]))
    else:
        state = pack_state(ray_o, ray_d, atten, seed, alive, UNIFORM_BUDGET,
                           pix, color=color)
    key = _state_key(state, scene, engine, mode)
    # The packed engine always adds per channel (JAX's _wavefront_packed).
    deposits = _Deposits(p, alive.device,
                         "ch" if packed else _deposit_mode(dense_pix))
    lad = _Ladder(scene, sky_on, cfg, deposits, engine, mode, glue, gather)
    wave_bcap = 1 if engine == "split" else knobs.wave_bcap()
    bounce = start_bounce
    widths = round_widths(p)
    for li, width in enumerate(widths):
        if handoff_width is not None and width <= handoff_width:
            budget = cfg.max_bounces - bounce
            if deposits.mode == "grave":
                # The survivors deposit in the tail; zero rows keep the
                # graveyard one row a ray.
                deposits.add(_pix(state), torch.zeros(
                    (3, width), dtype=torch.float32, device=alive.device))
            if isinstance(state, tuple):
                state = packed_to_state(*state, budget, state[1][1])
            else:
                state[ROW_BUDGET] = budget
            return deposits.colors(), lad.rays, state
        is_last = li == len(widths) - 1
        next_width = None if is_last else widths[li + 1]
        ordered = packed or _ordered(width)
        live = int(_alive(state).sum())
        while (bounce < cfg.max_bounces and live > 0
               and (is_last or live > next_width)):
            cap = min(wave_bcap, cfg.max_bounces - bounce)
            state, key, live = lad.round(state, key, cap, ordered)
            bounce += cap
        if is_last:
            deposits.add_state(state)
            break
        state, key = lad.shrink(state, key, next_width)
    return deposits.colors(), lad.rays, None


def wavefront_tail(scene: FastScene, state: torch.Tensor, sky_on: bool,
                   cfg: RenderConfig, out_size: int):
    """Deep rounds over the merged band survivors (round state with global
    pixel ids, pads >= out_size, and per-ray budgets). A ray is alive only
    while its budget is > 0: rays handed off at their bounce cap die there,
    black without the colour carry, keeping their colour with it. Rounds
    run ``RAYTPU_TAIL_BCAP`` bounces; the budget stops each ray where
    one-bounce rounds would. Returns (color f32[3, out_size], rays
    traced)."""
    mode = knobs.sort_key_mode()
    tail_bcap = knobs.tail_bcap()
    alive = state[ROW_ALIVE] != 0
    kill = alive & (state[ROW_BUDGET] <= 0)
    nocolor = state.shape[0] == STATE_ROWS
    if nocolor:
        f = state[6:9].view(torch.float32)
        f.copy_(torch.where(kill, 0.0, f))
    state[ROW_ALIVE] = (alive & ~kill).to(torch.int32)
    engine = "fused12" if nocolor else "fused"
    key = _state_key(state, scene, engine, mode)
    deposits = _Deposits(out_size, state.device, _deposit_mode(False))
    lad = _Ladder(scene, sky_on, cfg, deposits, engine, mode)
    widths = round_widths(state.shape[1])
    for li, width in enumerate(widths):
        is_last = li == len(widths) - 1
        next_width = None if is_last else widths[li + 1]
        ordered = _ordered(width)
        live = int(_alive(state).sum())
        while live > (0 if is_last else next_width):
            state, key, live = lad.round(state, key, tail_bcap, ordered)
        if is_last:
            deposits.add_state(state)
            break
        state, key = lad.shrink(state, key, next_width)
    return deposits.colors(), lad.rays
