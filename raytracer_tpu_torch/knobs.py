"""Path knobs: the JAX package's own environment variables, read at call
time.

Each function reads its variable when it is called, so a process may
switch paths between frames (there is no trace cache to key on them). The
defaults are the JAX package's TPU defaults. A value that names a path
with no Pallas kernel behind it (the XLA megakernel ``RAYTPU_BOUNCE=mega``,
the ``RAYTPU_B0`` variants) raises ``NotImplementedError`` naming the knob.

* ``RAYTPU_BOUNCE``: ``wave`` (sorted rounds) or ``pmega`` (one sort, then
  the whole bounce chain in one kernel call);
* ``RAYTPU_WAVE``: the round engine, ``fused12``, ``fused``,
  ``fused_packed`` or ``split``;
* ``RAYTPU_TRAVERSE``: ``bvh4`` walks the 8-wide table; any other value
  walks the binary ``nodes8`` table (as ``pallas_trace.pallas_traverse``
  reads it);
* ``RAYTPU_NODE_SRC``: ``pack`` or ``extract``; ``extract`` also selects
  the binary walk;
* ``RAYTPU_B0``: ``pallas`` only (bounce 0 through the traversal kernel);
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
glue, table layout, BVH builder, native library). Each is read where the
JAX package reads it, and any value but its JAX default raises
``NotImplementedError``.

The JAX package's TPU tile-shape knobs change no result and do not apply
to the port, which does not read them: ``RAYTPU_PALLAS_SUBLANES``,
``RAYTPU_PALLAS_BSUBLANES``, ``RAYTPU_PALLAS_UNROLL`` and
``RAYTPU_TRAVERSE_UNROLL``.
"""

from __future__ import annotations

import os

BOUNCE_PATHS = ("wave", "pmega")
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
# * ``packet.render_linear_fast`` with the bounce path: COMPACT_FLOOR and
#   COMPACT_RATIO (packet.py:320-322, the ``mega`` bounce path's);
# * ``FastScene``: CLUSTER and WIDE (fast_types.py:40, :67);
# * ``bvh/build.build_bvh``: BVH and NATIVE (build.py:103-104);
#   ``scene/builder.py``: NATIVE, LEAF_COUNTS (builder.py:252, :294);
#   ``scene/objloader.load_obj``: NATIVE (objloader.py:24).
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
    "RAYTPU_COMPACT_FLOOR": "1024",
    "RAYTPU_COMPACT_RATIO": "2",
    "RAYTPU_CLUSTER": "8",
    "RAYTPU_WIDE": "8",
    "RAYTPU_BVH": "sah",
    "RAYTPU_NATIVE": "1",
    "RAYTPU_LEAF_COUNTS": "1",
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
    """``RAYTPU_B0``: "pallas" only (bounce 0 through the traversal
    kernel)."""
    return _read("RAYTPU_B0", "pallas", ("pallas",))


def bounce_path() -> str:
    """``RAYTPU_BOUNCE``: "wave" (default) or "pmega"."""
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
    the sorted-round path with a fused engine, path shading and more than
    one bounce (the wide table is always built)."""
    return (cfg.max_bounces > 1 and cfg.shading != "fixed_light"
            and bounce_path() == "wave" and wave_engine() != "split")


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
