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
condition does on the device; a ladder's entry is read too, and after a
shrink the count carries (``_Ladder.shrink``). Every fixed-width step
(round, shrink, hand-off, last deposit, tail entry) reads and writes
buffers of the ladder's space (``kernels/stepgraphs.py``): fresh ones run
eagerly, or a scene's static ones whose steps replay CUDA graphs.
"""

from __future__ import annotations

import functools

import torch

from raytracer_tpu_torch import knobs
from raytracer_tpu_torch.core.fast_types import FastScene
from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.kernels import launches, stepgraphs
from raytracer_tpu_torch.kernels.bounce import (COLOR_ROWS, ROW_ALIVE,
                                                ROW_BUDGET, ROW_PIX,
                                                ROW_SEED, SF_ROWS,
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
    dead_bit = 30 if _kernel_key(engine, mode) else 31
    return sort_key(o, d, _alive(state), *scene.bounds(), mode, dead_bit)


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

    * ``grave``: no adds; each deposit writes (pixel id, colour bits) rows
      into a graveyard i32[rows, 4] at an offset its ladder fixes (every
      row written once a ladder), and ``colors`` sorts them by pixel id
      (one stable argsort and one row gather). Only under the
      dense-pixel promise of a band: each id < n at most once (a gather
      keeps a -0.0 deposit, which an add onto zeros turns into +0.0);
    * ``rows``: one add of [m, 3] rows into f32[n + 1, 3];
    * ``ch``: one add a channel into f32[3, n + 1].

    The storage comes from ``space`` (``kernels/stepgraphs.py``) under
    ``role``; ``reset`` zeroes the adds' cells."""

    def __init__(self, n: int, device, mode: str,
                 space: stepgraphs.Space = stepgraphs.PLAIN,
                 role: str = "band", rows: int | None = None):
        self.n, self.mode = n, mode
        name = (role, "deposits")
        if mode == "grave":
            self.grave = space.buf(name, (rows or n, 4), torch.int32, device)
        elif mode == "rows":
            self.out = space.buf(name, (n + 1, 3), torch.float32, device)
        else:
            self.out = space.buf(name, (3, n + 1), torch.float32, device)
        if not space.static:
            self.reset()

    def reset(self) -> None:
        if self.mode != "grave":
            self.out.zero_()

    def add(self, pix: torch.Tensor, dep: torch.Tensor, at: int = 0) -> None:
        """Deposit dep f32[3, m] at pixel ids pix i32[m] (graveyard: into
        rows ``at``..``at + m``)."""
        if self.mode == "grave":
            bits = dep.view(torch.int32)
            torch.stack([pix, bits[0], bits[1], bits[2]], dim=1,
                        out=self.grave[at:at + pix.shape[0]])
            return
        idx = torch.clamp(pix, max=self.n).to(torch.int64)
        if self.mode == "rows":
            self.out.index_add_(0, idx, dep.T)
        else:
            for c in range(3):
                self.out[c].index_add_(0, idx, dep[c])

    def add_state(self, state, at: int = 0) -> None:
        self.add(_pix(state), _deposits(state), at)

    def colors(self, out: torch.Tensor | None = None) -> torch.Tensor:
        """f32[3, n]: the cells (graveyard: the first n rows in pixel id
        order, the pads' after every real pixel), written into ``out``
        when given."""
        if self.mode == "grave":
            g = self.grave.index_select(
                0, torch.argsort(self.grave[:, 0], stable=True))
            cells = g[:self.n, 1:4].T.view(torch.float32)
        elif self.mode == "rows":
            cells = self.out[:self.n].T
        else:
            cells = self.out[:, :self.n]
        if out is not None:
            return out.copy_(cells)
        return cells if self.mode == "ch" else cells.contiguous()


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


def _parts(state) -> tuple:
    return state if isinstance(state, tuple) else (state,)


def _ordered(width: int) -> bool:
    """Whether a level of ``width`` rays walks near-first
    (``RAYTPU_ORDER_MINW``)."""
    order_minw = knobs.order_minw()
    return order_minw == 0 or width >= order_minw


class _Ladder:
    """The round/shrink loop of a band wavefront (``role`` "band") or of
    the tail ("tail") over levels of static width ``widths``: one state
    buffer X[w] (i32[rows, w], or the packed pair) and one key buffer K[w]
    a level, the deposits into ``n`` cells and their colours C f32[3, n],
    the rays traced and the round counts, all from the ladder's space
    (``kernels/stepgraphs.py``). Each step reads and writes only these,
    so the same functions run eagerly or as replayed graphs:

    * ``round`` (w, cap): stable argsort of K[w], gather of X[w], one
      round of up to ``cap`` bounces writing X[w], K[w] and the counts;
    * ``shrink`` (w, w'): sort, the dead tail past w' deposited (the
      graveyard at its static offset P - w), the prefix into X[w'], K[w'];
    * ``handoff`` (w): a band's zero deposits of its survivors (graveyard)
      and its colours, the survivors left in X[w];
    * ``last`` (w): the last level's deposits and the colours;
    * ``entry``: the tail's entry (budget kills, key, live count).

    ``caps`` lists the bounces a round may run, ``handoff`` whether the
    last of ``widths`` is a band's hand-off level; ``entry``: the tail's
    input state, which a plain space takes as X of the first level."""

    def __init__(self, scene: FastScene, sky_on: bool, cfg: RenderConfig,
                 engine: str, mode: str, widths: list, caps: tuple,
                 deposit_mode: str, n: int, role: str, glue: str = "one",
                 gather: str = "col", rows: int = STATE_ROWS,
                 handoff: bool = False, entry=None):
        self.scene, self.sky_on, self.cfg = scene, sky_on, cfg
        self.engine, self.mode = engine, mode
        self.glue, self.gather = glue, gather
        self.widths, self.caps, self.handoff = widths, caps, handoff
        self.role = role
        self.kernel_key = _kernel_key(engine, mode)
        # The build launched: the key's own where the rounds carry it,
        # else the default (its key is not read).
        self.build_key = mode if self.kernel_key else "cid"
        self.packed = engine == "fused_packed"
        self.ordered = {w: self.packed or _ordered(w) for w in widths}
        # The scene itself is no part of the key: a workspace holds one
        # scene's graphs, and a new scene object gets a new workspace.
        self.key = (role, engine, mode, glue, gather, deposit_mode,
                    bool(sky_on), cfg.fuzz, cfg.emissive_emits, cfg.t_min,
                    cfg.t_max, cfg.det_eps, scene.layout, str(scene.device),
                    rows, n, tuple(widths), tuple(caps),
                    tuple(self.ordered[w] for w in widths), handoff)
        sp = self.space = stepgraphs.space(scene, self.key, engine)
        dev = scene.device
        key_dtype = torch.int32 if self.kernel_key else torch.int64

        def state(w):
            if self.packed:
                return (sp.buf((role, "sf"), (SF_ROWS, w), torch.float32,
                               dev),
                        sp.buf((role, "si"), (2, w), torch.int32, dev))
            return sp.buf((role, "state"), (rows, w), torch.int32, dev)

        self.X = {w: state(w) for w in widths[1:]}
        self.X[widths[0]] = (entry if entry is not None and not sp.static
                             else state(widths[0]))
        self.K = {w: sp.buf((role, "key"), (w,), key_dtype, dev)
                  for w in widths}
        self.C = sp.buf((role, "colors"), (3, n), torch.float32, dev)
        self.counts = sp.buf((role, "counts"), (3,), torch.int64, dev)
        self.live = sp.buf((role, "live"), (), torch.int64, dev)
        self.rays = sp.buf((role, "rays"), (), torch.int64, dev)
        self.deposits = _Deposits(n, dev, deposit_mode, sp, role, widths[0])
        if sp.static:
            # The tail's input is in X of its first level already.
            keep = _parts(self.X[widths[0]]) if entry is not None else ()
            sp.prepare(self.key, self.steps, keep)

    def steps(self) -> list:
        """Every step of the ladder as (key, kind, fn), in ladder order,
        each round at every bounce cap it may run."""
        out = [self._step("entry")] if self.role == "tail" else []
        for li, w in enumerate(self.widths):
            last = li == len(self.widths) - 1
            if last and self.handoff:
                out.append(self._step("handoff", w))
                break
            out += [self._step("round", w, cap) for cap in self.caps]
            out.append(self._step("last", w) if last
                       else self._step("shrink", w, self.widths[li + 1]))
        return out

    def _step(self, kind: str, *args):
        return (stepgraphs.step_key(self.key, kind, *args), kind,
                functools.partial(getattr(self, "_" + kind), *args))

    def run(self, kind: str, *args) -> None:
        self.space.run(*self._step(kind, *args))

    def set_key(self, w: int, key: torch.Tensor) -> None:
        if self.space.static:
            self.K[w].copy_(key)
        else:
            self.K[w] = key

    # --- the steps -------------------------------------------------------

    def _round(self, w: int, cap: int) -> None:
        state, key = self.X[w], self.K[w]
        order = torch.argsort(key, stable=True)
        state_in = _gather(state, order, self.glue, self.gather)
        kkey = (key if self.kernel_key
                else torch.empty(w, dtype=torch.int32, device=key.device))
        args = (cap, self.sky_on, self.cfg)
        if self.packed:
            bounce_packed(self.scene, *state_in, *args,
                          key_mode=self.build_key,
                          out=(*state, kkey, self.counts))
        else:
            kernel = bounce12 if self.engine == "fused12" else bounce15
            kernel(self.scene, state_in, *args, key_mode=self.build_key,
                   ordered=self.ordered[w], out=(state, kkey, self.counts))
        self.rays += self.counts[0]
        if not self.kernel_key:
            key.copy_(_state_key(state, self.scene, self.engine, self.mode))

    def _shrink(self, w: int, w2: int) -> None:
        state, key = _sorted(self.X[w], self.K[w], self.gather)
        tail = tuple(x[:, w2:] for x in _parts(state))
        self.deposits.add_state(tail if self.packed else tail[0],
                                at=self.widths[0] - w)
        for dst, src in zip(_parts(self.X[w2]), _parts(state)):
            dst.copy_(src[:, :w2])
        self.K[w2].copy_(key[:w2])

    def _handoff(self, w: int) -> None:
        if self.deposits.mode == "grave":
            # The survivors deposit in the tail; zero rows keep the
            # graveyard one row a ray.
            self.deposits.add(_pix(self.X[w]), torch.zeros(
                (3, w), dtype=torch.float32, device=self.C.device),
                at=self.widths[0] - w)
        self.deposits.colors(out=self.C)

    def _last(self, w: int) -> None:
        self.deposits.add_state(self.X[w], at=self.widths[0] - w)
        self.deposits.colors(out=self.C)

    def _entry(self) -> None:
        w = self.widths[0]
        state = self.X[w]
        alive = state[ROW_ALIVE] != 0
        kill = alive & (state[ROW_BUDGET] <= 0)
        if state.shape[0] == STATE_ROWS:
            f = state[6:9].view(torch.float32)
            f.copy_(torch.where(kill, 0.0, f))
        state[ROW_ALIVE] = (alive & ~kill).to(torch.int32)
        self.set_key(w, _state_key(state, self.scene, self.engine,
                                   self.mode))
        self.live.copy_(_alive(state).sum())
        self.rays.zero_()
        if self.space.static:
            self.deposits.reset()

    # --- the host's side of the loop -------------------------------------

    def round(self, w: int, cap: int = 1) -> int:
        """One sorted round of up to ``cap`` bounces at level ``w`` -> the
        live count (read on the host)."""
        if self.engine == "split":
            launches.graphs["eager.round"] += 1
            order = torch.argsort(self.K[w], stable=True)
            state = _gather(self.X[w], order, self.glue, self.gather)
            self.X[w], self.K[w], live = self._split_round(state)
            return live
        self.run("round", w, cap)
        return int(self.counts[1])

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

    def shrink(self, w: int, w2: int, live: int) -> int:
        """Sort, deposit the tail past w2, keep the prefix -> the live
        count of the prefix, with no read: the key's dead bit sorts every
        live ray ahead of the dead ones (a stable sort), so the kept
        prefix holds min(live, w2) of them, and the rounds leave a level
        with live <= w2 unless they ran out of bounces."""
        self.run("shrink", w, w2)
        return min(live, w2)

    def outputs(self, out: torch.Tensor | None = None):
        """(colours, rays traced) that outlive the ladder: written into
        ``out`` (f32[3, m], the first m cells) when given; copies where
        the space's buffers serve the next ladder too."""
        colors = self.C
        if out is not None:
            colors = out.copy_(colors[:, :out.shape[1]])
        elif self.space.static:
            colors = colors.clone()
        rays = self.rays.clone() if self.space.static else self.rays
        return colors, rays


def wavefront_bounces(scene: FastScene, ray_o, ray_d, color, atten, seed,
                      alive, sky_on: bool, cfg: RenderConfig, pix,
                      handoff_width: int | None = None,
                      start_bounce: int = 1, dense_pix: bool = False,
                      out: torch.Tensor | None = None,
                      survivors_out: torch.Tensor | None = None):
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
    ``color``). ``out`` (f32[3, m]) takes the first m colours and is
    returned in their place; ``survivors_out`` takes the survivors."""
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
    widths = round_widths(p)
    hand = None
    if handoff_width is not None:
        hand = next((w for w in widths if w <= handoff_width), None)
        if hand is not None:
            widths = widths[:widths.index(hand) + 1]
    wave_bcap = 1 if engine == "split" else knobs.wave_bcap()
    caps = tuple(range(1, min(wave_bcap, cfg.max_bounces - start_bounce)
                       + 1))
    # The packed engine always adds per channel (JAX's _wavefront_packed).
    lad = _Ladder(scene, sky_on, cfg, engine, mode, widths, caps,
                  "ch" if packed else _deposit_mode(dense_pix), p, "band",
                  glue, gather, STATE_ROWS if engine == "fused12"
                  else COLOR_ROWS, handoff=hand is not None)
    state = lad.X[p]
    if engine == "fused12":
        # No-color carry: dead entrants' colours (their deposits) ride in
        # the atten rows; live entrants' colours are necessarily 0.
        atten = tuple(torch.where(alive, a, c) for a, c in zip(atten, color))
        pack_state(ray_o, ray_d, atten, seed, alive, UNIFORM_BUDGET, pix,
                   out=state)
    elif packed:
        torch.stack([*ray_o, *ray_d, *color, *atten,
                     alive.to(torch.float32)], out=state[0])
        torch.stack([seed.to(torch.int32), pix.to(torch.int32)],
                    out=state[1])
    else:
        pack_state(ray_o, ray_d, atten, seed, alive, UNIFORM_BUDGET, pix,
                   color=color, out=state)
    lad.set_key(p, _state_key(state, scene, engine, mode))
    lad.rays.zero_()
    if lad.space.static:
        lad.deposits.reset()
    bounce = start_bounce
    # The band's one level read (none where it hands off at once): after
    # a shrink the count carries (``_Ladder.shrink``).
    live = 0 if hand == p else int(_alive(state).sum())
    for li, width in enumerate(widths):
        if hand is not None and width == hand:
            lad.run("handoff", width)
            colors, rays = lad.outputs(out)
            state = lad.X[width]
            # The budget changes from frame to frame: written here,
            # outside every graph.
            budget = cfg.max_bounces - bounce
            if packed:
                return colors, rays, packed_to_state(
                    *state, budget, state[1][1], out=survivors_out)
            surv = survivors_out
            if surv is None:
                surv = (torch.empty_like(state) if lad.space.static
                        else state)
            if surv is not state:
                surv.copy_(state)
            surv[ROW_BUDGET] = budget
            return colors, rays, surv
        is_last = li == len(widths) - 1
        next_width = None if is_last else widths[li + 1]
        while (bounce < cfg.max_bounces and live > 0
               and (is_last or live > next_width)):
            cap = min(wave_bcap, cfg.max_bounces - bounce)
            live = lad.round(width, cap)
            bounce += cap
        if is_last:
            lad.run("last", width)
            break
        live = lad.shrink(width, next_width, live)
    return (*lad.outputs(out), None)


def tail_input(scene: FastScene, width: int) -> torch.Tensor:
    """The round state the bands hand their survivors into for
    ``wavefront_tail`` (i32[13, width] on the fused12 engine, else
    i32[16, width]): the tail's own first-level buffer where the scene has
    a workspace (``kernels/stepgraphs.py``), else new."""
    rows = STATE_ROWS if knobs.wave_engine() == "fused12" else COLOR_ROWS
    ws = stepgraphs.workspace(scene)
    if ws is None:
        return torch.empty((rows, width), dtype=torch.int32,
                           device=scene.device)
    return ws.buf(("tail", "state"), (rows, width), torch.int32,
                  scene.device)


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
    engine = "fused12" if state.shape[0] == STATE_ROWS else "fused"
    widths = round_widths(state.shape[1])
    lad = _Ladder(scene, sky_on, cfg, engine, mode, widths, (tail_bcap,),
                  _deposit_mode(False), out_size, "tail",
                  rows=state.shape[0], entry=state)
    first = lad.X[widths[0]]
    if first.data_ptr() != state.data_ptr():
        first.copy_(state)
    lad.run("entry")
    # The one level read of the tail: after a shrink the count carries
    # (``_Ladder.shrink``).
    live = int(lad.live)
    for li, width in enumerate(widths):
        is_last = li == len(widths) - 1
        next_width = None if is_last else widths[li + 1]
        while live > (0 if is_last else next_width):
            live = lad.round(width, tail_bcap)
        if is_last:
            lad.run("last", width)
            break
        live = lad.shrink(width, next_width, live)
    return lad.outputs()
