"""Launch counts of the hand-written kernels and calls of their plain
versions, keyed by wrapper name ("trace4", "bounce12", "tonemap").

A wrapper adds one to ``kernel`` where it launches its kernel and to
``plain`` where it runs the plain version, and nowhere else, so a run can
show which path a frame went through.
"""

import collections

kernel: collections.Counter = collections.Counter()
plain: collections.Counter = collections.Counter()


def reset() -> None:
    kernel.clear()
    plain.clear()
