"""Path knobs: the JAX package's own environment variables, read at call
time.

Each function reads its variable when it is called, so a process may
switch paths between frames (there is no trace cache to key on them). The
defaults are the JAX package's TPU defaults (``RAYTPU_B0=pallas``,
``RAYTPU_BOUNCE=wave``); the JAX package's default on other backends, the
XLA render path (``mega``), is reached only through the knobs, as on the
TPU. A value the port does not have raises ``NotImplementedError`` naming
the knob.

* ``RAYTPU_BOUNCE``: ``wave`` (sorted rounds), ``pmega`` (one sort, then
  the whole bounce chain in one kernel call) or ``mega`` (the fused
  per-ray loop of ``kernels/packet.megakernel_bounces``, the ``mega``
  kernel, from bounce 1);
* ``RAYTPU_WAVE``: the round engine, ``fused12``, ``fused``,
  ``fused_packed`` or ``split``;
* ``RAYTPU_TRAVERSE``: ``bvh4`` walks the 8-wide table; any other value
  walks the binary ``nodes8`` table (as ``pallas_trace.pallas_traverse``
  reads it);
* ``RAYTPU_NODE_SRC``: ``pack`` or ``extract``; ``extract`` also selects
  the binary walk;
* ``RAYTPU_B0``: ``pallas`` (bounce 0 through the traversal kernel, then
  ``RAYTPU_BOUNCE``), ``pwave`` (bounce 0 inside the sorted rounds, kernel
  B from bounce 0), ``mega`` (every bounce in the ``mega`` kernel, raster
  order) or ``packet`` (8x8-tile groups through the union walk, then the
  ``mega`` kernel from bounce 1); ``mega`` and ``packet`` ignore
  ``RAYTPU_BOUNCE``, as in the JAX package; under any value but
  ``pallas`` the fixed-light tier walks the binary table per ray
  (``trace2``) on raster primaries;
* ``RAYTPU_BVH``: the host tree of every scene pack, ``sah`` (default),
  ``median``, ``sbvh`` (spatial splits: ``order`` repeats triangles) or
  ``ploc``; ``RAYTPU_NATIVE=0`` builds it in NumPy (``median`` for
  ``sah`` / ``median`` / ``sbvh``, as the JAX package falls back, and the
  NumPy PLOC for ``ploc``), packs clusters in NumPy and parses ``.obj``
  in Python; ``RAYTPU_LEAF_COUNTS=0`` encodes full counts in the wide
  leaf metas. With the native library on, a native failure raises (the
  JAX package logs it and builds a median tree instead);
* ``RAYTPU_DEVICE_BUILD``: the live-edit scene build
  (``scene/device_builder.py``), ``instanced`` (default), ``refit`` or
  ``lbvh``; ``RAYTPU_DEVICE_TREE``: the LBVH build's tree, ``karras``
  (default, ``bvh/lbvh.py``) or ``ploc`` (``bvh/ploc_device.py``);
  ``RAYTPU_REFIT_TOPO``: the refit capture's host tree, ``ploc``
  (default) or ``sah``.

The sorted rounds' A/B knobs (``kernels/wavefront.py``,
``kernels/packet.py``), each read at call time where the JAX package reads
it at trace time, or, for the level schedule, at import
(``raytracer_tpu/kernels/wavefront.py:57-95``): a process may switch them
between frames, and a test sets them with ``monkeypatch.setenv``.

* ``RAYTPU_SORT_KEY`` (``sort_key_mode``): ``cid`` (default), ``pd5`` or
  ``om9``, which kernel B emits (its builds of that key), or ``pos``,
  ``oct_morton`` or any other value (the ``oct_morton`` form), which the
  host computes after each round (``kernels/keys.py``);
* ``RAYTPU_GLUE``: the round gather of the band rounds, ``one``
  (default: one gather of the round state), ``perfield`` (one gather a
  field), ``packT`` (a row gather of the transposed state, then a
  transpose back) or any other value (the f32 rows and the i32 rows as
  two gathers); ``perfield`` and ``packT`` raise under ``fused12``, where
  the JAX package fails with a ``TypeError`` (it iterates the colour that
  the no-colour carry drops);
* ``RAYTPU_DEPOSIT``: ``grave`` (default: each level's dead tail goes to a
  graveyard of (pixel, colour) rows, one argsort of the pixel ids and a
  row gather a band; band rounds only, elsewhere as ``ch``), ``rows``
  (one ``[n, 3]`` add a level) or any other value (``ch``: one add a
  channel); the packed engine always adds a channel at a time;
* ``RAYTPU_PACK_GATHER``: ``col`` (default) gathers the packed engine's
  state along its ray axis; ``row`` transposes, gathers rows and
  transposes back;
* ``RAYTPU_TAIL_MERGE``: ``0`` turns the cross-band tail merge off;
* the level schedule: ``RAYTPU_WAVE_MINW`` (the narrowest level, rounded
  up to whole 2048-ray tiles; unset, ``wavefront.MIN_WIDTH``),
  ``RAYTPU_WAVE_BCAP`` and ``RAYTPU_TAIL_BCAP`` (bounces a fused band
  round and a tail round runs, at least 1), ``RAYTPU_ORDER_MINW``
  (levels narrower than this walk unordered; 0, the default, never),
  ``RAYTPU_DEEP_SUB`` (widths floor to ``DEEP_SUB * 128`` rays) and
  ``RAYTPU_DEEP_MAXW``. The tile sublanes that ``DEEP_SUB`` and
  ``DEEP_MAXW`` select for the TPU's deep levels (``_level_sub``) have
  no counterpart in a kernel that runs one ray a thread, and change no
  result: like ``RAYTPU_PALLAS_BSUBLANES`` they do not apply;
  ``DEEP_MAXW`` is read with ``DEEP_SUB`` and used nowhere else.

Counts read at call time where the JAX package reads them (``count``):
``RAYTPU_REFIT_REFRESH`` (edits between refit recaptures),
``RAYTPU_PIPELINE`` (frames in flight in ``engine/loop.py``),
``RAYTPU_LADDER`` and ``RAYTPU_LADDER_SCALE`` (the resolution ladder).

The table layout, read when a table is built (``layout``: the host
builders, the device builders and ``fast_scene_from_numpy``), where the
JAX package reads it at import (``raytracer_tpu/core/fast_types.py:40``,
``:67``); the scene keeps it (``FastScene.cluster_size`` /
``wide_width``), and every walk and kernel library takes it from there:

* ``RAYTPU_CLUSTER``: triangles a leaf, ``8`` (default), ``4`` or ``2``
  (thin leaves: subclusters of the 128-float cluster rows);
* ``RAYTPU_WIDE``: children a wide node, ``8`` (default) or ``16`` (a
  node is two 128-float rows; the device LBVH then builds no wide table
  and its scenes walk the binary one).

Every result-bearing knob of the JAX package runs its JAX values: the
port refuses none (``FIXED`` is empty).

The JAX package's TPU tile-shape knobs change no result and do not apply
to the port, which does not read them: ``RAYTPU_PALLAS_SUBLANES``,
``RAYTPU_PALLAS_BSUBLANES``, ``RAYTPU_PALLAS_UNROLL`` and
``RAYTPU_TRAVERSE_UNROLL``. The megakernel's compaction levels,
``RAYTPU_COMPACT_FLOOR`` and ``RAYTPU_COMPACT_RATIO``, change no result
either (a TPU schedule: each ray's path is its own): the plain
``megakernel_bounces`` reads them where the JAX package does and runs
the levels; the ``mega`` kernel on the card runs every ray to its end in
one launch and does not read them.
"""

from __future__ import annotations

import os

from raytracer_tpu_torch.core.fast_types import CLUSTER_SIZES, WIDE_WIDTHS

BOUNCE0 = ("pallas", "pwave", "mega", "packet")
BOUNCE_PATHS = ("wave", "pmega", "mega")
BVH_METHODS = ("sah", "median", "sbvh", "ploc")
DEVICE_BUILDS = ("instanced", "refit", "lbvh")
DEVICE_TREES = ("karras", "ploc")
WAVE_ENGINES = ("fused12", "fused", "fused_packed", "split")
NODE_SOURCES = ("pack", "extract")

# Knob -> its JAX default, for knobs whose other values the port refuses.
# Every knob runs its JAX values now.
FIXED: dict = {}


def _read(name: str, default: str, allowed) -> str:
    value = os.environ.get(name, default)
    if value not in allowed:
        raise NotImplementedError(
            f"{name}={value!r} selects a path the port does not have "
            f"(ported: {', '.join(allowed)})")
    return value


def layout() -> tuple[int, int]:
    """(cluster size, wide width) for a table built now:
    ``RAYTPU_CLUSTER`` (8, 4 or 2) and ``RAYTPU_WIDE`` (8 or 16)."""
    return (int(_read("RAYTPU_CLUSTER", "8", tuple(map(str, CLUSTER_SIZES)))),
            int(_read("RAYTPU_WIDE", "8", tuple(map(str, WIDE_WIDTHS)))))


def bounce0() -> str:
    """``RAYTPU_B0``: "pallas" (default), "pwave", "mega" or "packet"."""
    return _read("RAYTPU_B0", "pallas", BOUNCE0)


def bounce_path() -> str:
    """``RAYTPU_BOUNCE``: "wave" (default), "pmega" or "mega"."""
    return _read("RAYTPU_BOUNCE", "wave", BOUNCE_PATHS)


def wave_engine() -> str:
    """``RAYTPU_WAVE``: "fused12" (default), "fused", "fused_packed" or
    "split"."""
    return _read("RAYTPU_WAVE", "fused12", WAVE_ENGINES)


def binary_traverse() -> bool:
    """True when traversal walks the binary ``nodes8`` table (kernel
    ``trace2``) instead of the wide ``nodes4`` table (``trace4``)."""
    node_src = _read("RAYTPU_NODE_SRC", "pack", NODE_SOURCES)
    return (node_src == "extract"
            or os.environ.get("RAYTPU_TRAVERSE", "bvh4") != "bvh4")


def tail_merge_active(cfg) -> bool:
    """The JAX ``packet.tail_merge_active`` rule: band tails merge only on
    the sorted-round path after the traversal kernel's bounce 0, with a
    fused engine, path shading and more than one bounce (the wide table
    is always built)."""
    return (cfg.max_bounces > 1 and cfg.shading != "fixed_light"
            and bounce0() == "pallas" and bounce_path() == "wave"
            and wave_engine() != "split")


def bvh_method() -> str:
    """``RAYTPU_BVH``: the host tree, "sah" (default), "median", "sbvh" or
    "ploc"."""
    return _read("RAYTPU_BVH", "sah", BVH_METHODS)


def native() -> bool:
    """``RAYTPU_NATIVE``: False only for "0" (NumPy builds, NumPy cluster
    packing, the Python ``.obj`` parser), as the JAX package reads it."""
    return os.environ.get("RAYTPU_NATIVE", "1") != "0"


def leaf_counts() -> bool:
    """``RAYTPU_LEAF_COUNTS``: False only for "0" (the wide leaf metas
    carry full counts), as the JAX package reads it."""
    return os.environ.get("RAYTPU_LEAF_COUNTS", "1") != "0"


def compact_levels() -> tuple[int, int]:
    """(floor, ratio) of the plain megakernel's width levels:
    ``RAYTPU_COMPACT_FLOOR`` (1024) and ``RAYTPU_COMPACT_RATIO`` (2),
    the ratio at least 2 (a smaller one would never shrink)."""
    return (count("RAYTPU_COMPACT_FLOOR", 1024),
            max(2, count("RAYTPU_COMPACT_RATIO", 2)))


def device_build() -> str:
    """``RAYTPU_DEVICE_BUILD``: "instanced" (default), "refit" or
    "lbvh"."""
    return _read("RAYTPU_DEVICE_BUILD", "instanced", DEVICE_BUILDS)


def device_tree() -> str:
    """``RAYTPU_DEVICE_TREE``: "karras" (default, the Morton / Karras
    tree) or "ploc" (the device PLOC tree)."""
    return _read("RAYTPU_DEVICE_TREE", "karras", DEVICE_TREES)


def refit_topo() -> str:
    """``RAYTPU_REFIT_TOPO``: the refit capture's host tree, "ploc"
    (default) or "sah"."""
    return _read("RAYTPU_REFIT_TOPO", "ploc", ("ploc", "sah"))


def count(name: str, default: int) -> int:
    """An integer knob (``RAYTPU_PIPELINE``, ``RAYTPU_LADDER``, ...),
    ``default`` when unset."""
    return int(os.environ.get(name, str(default)))


def sort_key_mode() -> str:
    """``RAYTPU_SORT_KEY``: "cid" (default), "pd5", "om9", "pos",
    "oct_morton"; any other value is taken, and keys as "oct_morton"."""
    return os.environ.get("RAYTPU_SORT_KEY", "cid")


def glue(engine: str) -> str:
    """``RAYTPU_GLUE`` for the band rounds of ``engine``: "one" (default),
    "perfield", "packT" or any other value (the f32 / i32 pair). Raises
    for "perfield" and "packT" under "fused12", which the JAX package
    cannot run (a ``TypeError`` on the colour the no-colour carry
    drops)."""
    value = os.environ.get("RAYTPU_GLUE", "one")
    if engine == "fused12" and value in ("perfield", "packT"):
        raise NotImplementedError(
            f"RAYTPU_GLUE={value!r} with RAYTPU_WAVE=fused12: the JAX "
            f"package fails there (its glue iterates the colour that the "
            f"no-colour carry drops); use RAYTPU_WAVE=fused or split")
    return value


def deposit() -> str:
    """``RAYTPU_DEPOSIT``: "grave" (default), "rows", or any other value
    (per-channel adds, "ch")."""
    return os.environ.get("RAYTPU_DEPOSIT", "grave")


def pack_gather() -> str:
    """``RAYTPU_PACK_GATHER``: "row", or "col" for any other value (the
    default)."""
    return ("row" if os.environ.get("RAYTPU_PACK_GATHER", "col") == "row"
            else "col")


def tail_merge() -> bool:
    """``RAYTPU_TAIL_MERGE``: False only for "0"."""
    return os.environ.get("RAYTPU_TAIL_MERGE", "1") != "0"


def wave_minw():
    """``RAYTPU_WAVE_MINW`` as an int, or None when unset."""
    value = os.environ.get("RAYTPU_WAVE_MINW")
    return None if value is None else int(value)


def wave_bcap() -> int:
    """``RAYTPU_WAVE_BCAP``: bounces a fused band round runs (>= 1)."""
    return max(1, count("RAYTPU_WAVE_BCAP", 1))


def tail_bcap() -> int:
    """``RAYTPU_TAIL_BCAP``: bounces a tail round runs (>= 1)."""
    return max(1, count("RAYTPU_TAIL_BCAP", 1))


def order_minw() -> int:
    """``RAYTPU_ORDER_MINW``: levels narrower than this walk unordered (0:
    none)."""
    return count("RAYTPU_ORDER_MINW", 0)


def deep_grain() -> tuple[int, int]:
    """(``RAYTPU_DEEP_SUB``, ``RAYTPU_DEEP_MAXW``): the deep levels' tile
    sublanes (0: off) and the widest deep level."""
    return count("RAYTPU_DEEP_SUB", 0), count("RAYTPU_DEEP_MAXW", 200000)
