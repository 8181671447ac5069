"""The choice between a hand-written kernel and its plain version, and the
count of each: launches keyed by kernel name ("trace4", "trace2",
"trace2_warp", "bounce12", "bounce15", "bounce_packed", "tonemap", "mega",
and "raygen" (``packet.primary_rays``), "shade" (``tracer.shade``) and
"sort_key" (``keys.sort_key``), with the table layout's and kernel B's
build suffixes; the measurement builds "bounce_packed_count" and
"mega_count" run on no path).

Every kernel wrapper asks ``on_card(name, device)``: True on a CUDA
device, where the wrapper launches its kernel and books it with
``launched(name)``; False on the CPU, or inside ``plain_versions()``
(which a test opens to run a frame's plain versions on the card), where
the wrapper runs the plain version, booked by ``on_card`` itself in
``plain``. Nothing else books, so a run can show which path a frame went
through. ``work`` sums the work the plain versions needed (node visits,
live child slots and sorting-network runs of the 8-wide walk, binary node
visits, live triangle tests, shaded rays, PCG draws), so a caller can
price the least time a kernel needs for the same inputs. The plain
versions of the JAX package's XLA walks book under the kernel that
replaces them on the card: ``ray_traverse_fast`` as "trace2",
``packet_traverse`` as "trace2_warp", ``megakernel_bounces`` as "mega".

``graphs`` counts the bounce engine's steps (``kernels/stepgraphs.py``)
by what ran them and their kind: "capture.round", "replay.shrink",
"eager.last", ... A replayed graph books the launches its capture made,
so ``kernel`` counts the same launches either way.
"""

import collections
import contextlib

import torch

kernel: collections.Counter = collections.Counter()
plain: collections.Counter = collections.Counter()
work: collections.Counter = collections.Counter()
graphs: collections.Counter = collections.Counter()

# The names of each open plain_versions() context, () for every wrapper.
_forced: list = []


def reset() -> None:
    kernel.clear()
    plain.clear()
    work.clear()
    graphs.clear()


def is_card(device) -> bool:
    """True for a CUDA device, False for the CPU; raises for any other."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device.type == "cuda"


def on_card(name: str, device) -> bool:
    """Whether the wrapper of kernel ``name`` launches it on ``device``:
    True on a CUDA device outside ``plain_versions()`` (of every wrapper
    or of ``name``); else books one plain call of ``name`` and returns
    False."""
    if is_card(device) and not any(not names or name in names
                                   for names in _forced):
        return True
    plain[name] += 1
    return False


def launched(name: str) -> None:
    """Book one launch of kernel ``name``."""
    kernel[name] += 1


def forced() -> bool:
    """Whether a ``plain_versions()`` context is open."""
    return bool(_forced)


@contextlib.contextmanager
def plain_versions(*names: str):
    """Send every kernel wrapper, or only the wrappers of the kernels
    ``names`` ("raygen", "trace4_c4", ...), to its plain version, on the
    card too, for the whole process while the context is open (a test
    seam: it nests, and restores the previous state on leaving)."""
    _forced.append(names)
    try:
        yield
    finally:
        _forced.remove(names)
