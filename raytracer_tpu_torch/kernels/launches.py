"""Launch counts of the hand-written kernels and calls of their plain
versions, keyed by wrapper name ("trace4", "trace2", "bounce12",
"bounce15", "bounce_packed", "tonemap").

A wrapper adds one to ``kernel`` where it launches its kernel and to
``plain`` where it runs the plain version, and nowhere else, so a run can
show which path a frame went through. ``work`` sums the work the
plain versions needed (node visits, live child slots and sorting-network
runs of the 8-wide walk, binary node visits, live triangle tests, shaded
rays, PCG draws), so a caller can price the least time a kernel needs for
the same inputs.
"""

import collections

kernel: collections.Counter = collections.Counter()
plain: collections.Counter = collections.Counter()
work: collections.Counter = collections.Counter()


def reset() -> None:
    kernel.clear()
    plain.clear()
    work.clear()
