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

Counts read at call time where the JAX package reads them (``count``):
``RAYTPU_REFIT_REFRESH`` (edits between refit recaptures),
``RAYTPU_PIPELINE`` (frames in flight in ``engine/loop.py``),
``RAYTPU_LADDER`` and ``RAYTPU_LADDER_SCALE`` (the resolution ladder).

The JAX package's other result-bearing knobs select A/B variants that the
port has not ported (``FIXED``: tail merge, sort key, round schedule and
glue, table layout). Each is read where the JAX package reads it, and any
value but its JAX default raises ``NotImplementedError``.

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

BOUNCE0 = ("pallas", "pwave", "mega", "packet")
BOUNCE_PATHS = ("wave", "pmega", "mega")
BVH_METHODS = ("sah", "median", "sbvh", "ploc")
DEVICE_BUILDS = ("instanced", "refit", "lbvh")
DEVICE_TREES = ("karras", "ploc")
WAVE_ENGINES = ("fused12", "fused", "fused_packed", "split")
NODE_SOURCES = ("pack", "extract")

# Knob -> its JAX default, the only value the port accepts. Read sites
# (the JAX package's in parentheses):
# * ``kernels/packet.tail_merge_widths``: TAIL_MERGE (packet.py:488);
# * ``kernels/wavefront.py`` rounds and tail, ``packet._pmega``: SORT_KEY
#   (wavefront.py:333, :803; packet.py:695), GLUE (:409), DEPOSIT (:180),
#   PACK_GATHER on the fused_packed engine (:661);
# * ``wavefront.round_widths``, the level schedule: WAVE_MINW, WAVE_BCAP,
#   TAIL_BCAP, ORDER_MINW, DEEP_SUB, DEEP_MAXW (wavefront.py:57-94, read
#   at import there);
# * ``FastScene``: CLUSTER and WIDE (fast_types.py:40, :67).
FIXED = {
    "RAYTPU_TAIL_MERGE": "1",
    "RAYTPU_SORT_KEY": "cid",
    "RAYTPU_GLUE": "one",
    "RAYTPU_DEPOSIT": "grave",
    "RAYTPU_PACK_GATHER": "col",
    "RAYTPU_WAVE_MINW": "8192",
    "RAYTPU_WAVE_BCAP": "1",
    "RAYTPU_TAIL_BCAP": "1",
    "RAYTPU_ORDER_MINW": "0",
    "RAYTPU_DEEP_SUB": "0",
    "RAYTPU_DEEP_MAXW": "200000",
    "RAYTPU_CLUSTER": "8",
    "RAYTPU_WIDE": "8",
}


def _read(name: str, default: str, allowed) -> str:
    value = os.environ.get(name, default)
    if value not in allowed:
        raise NotImplementedError(
            f"{name}={value!r} selects a path the port does not have "
            f"(ported: {', '.join(allowed)})")
    return value


def fixed(*names: str) -> None:
    """Read each knob of ``FIXED`` named; raise unless it is unset or at
    its JAX default."""
    for name in names:
        _read(name, FIXED[name], (FIXED[name],))


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
    ``trace2``) instead of the 8-wide ``nodes4`` table (``trace4``)."""
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
