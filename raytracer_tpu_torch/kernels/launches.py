"""Launch counts of the hand-written kernels and calls of their plain
versions, keyed by wrapper name ("trace4", "trace2", "trace2_warp",
"bounce12", "bounce15", "bounce_packed", "tonemap", "mega", and "raygen"
(``packet.primary_rays``), "shade" (``tracer.shade``) and "sort_key"
(``keys.sort_key``); the measurement builds "bounce12_pl" and
"bounce_packed_count" run on no path).

A wrapper adds one to ``kernel`` where it launches its kernel and to
``plain`` where it runs the plain version, and nowhere else, so a run can
show which path a frame went through. ``work`` sums the work the
plain versions needed (node visits, live child slots and sorting-network
runs of the 8-wide walk, binary node visits, live triangle tests, shaded
rays, PCG draws), so a caller can price the least time a kernel needs for
the same inputs. The plain versions of the JAX package's XLA walks book
under the kernel that replaces them on the card: ``ray_traverse_fast`` as
"trace2", ``packet_traverse`` as "trace2_warp", ``megakernel_bounces`` as
"mega".
"""

import collections

kernel: collections.Counter = collections.Counter()
plain: collections.Counter = collections.Counter()
work: collections.Counter = collections.Counter()


def reset() -> None:
    kernel.clear()
    plain.clear()
    work.clear()
