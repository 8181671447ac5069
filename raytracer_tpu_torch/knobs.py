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
* ``RAYTPU_B0``: ``pallas`` only (bounce 0 through the traversal kernel).
"""

from __future__ import annotations

import os

BOUNCE_PATHS = ("wave", "pmega")
WAVE_ENGINES = ("fused12", "fused", "fused_packed", "split")
NODE_SOURCES = ("pack", "extract")


def _read(name: str, default: str, allowed) -> str:
    value = os.environ.get(name, default)
    if value not in allowed:
        raise NotImplementedError(
            f"{name}={value!r} selects a path the port does not have "
            f"(ported: {', '.join(allowed)})")
    return value


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
