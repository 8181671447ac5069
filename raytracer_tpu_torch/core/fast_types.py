"""Packed scene layout for the packet tracer, as torch tensors.

Same tables, byte for byte, as ``raytracer_tpu.core.fast_types`` under the
same layout knobs (``RAYTPU_CLUSTER``, ``RAYTPU_WIDE``):

* ``nodes8`` f32[Mpad, 8]: binary pre-order nodes — bbox min(3) + max(3)
  + bitcast<i32> skip link + bitcast<i32> leaf cluster id (internal nodes:
  -(left child + 1)).
* ``clusters`` f32[Rows, 128]: 128-float rows of triangle records, 16
  floats each (v0.xyz, e1.xyz, e2.xyz, albedo.rgb, material type, unit
  normal.xyz). A leaf (cluster id ``cid``) holds ``cluster_size``
  records (2, 4 or 8); leaves are packed consecutively in cid order, so
  8 / ``cluster_size`` leaves share a row and leaf ``cid`` starts at float
  ``cid * cluster_size * 16`` of the flat table (``leaf_rows`` views it
  as f32[L, cluster_size * 16]).
* ``nodes4`` f32[Rpad, 128] or None: the ``wide_width``-wide collapse of
  the same tree (8 or 16), ``wide_width * 16`` floats a node (one row at
  8, two consecutive rows at 16: ``node_rows`` views it as f32[N,
  wide_width * 16]), each child [min(3) max(3) meta pad(9)]. meta > 0:
  internal wide id + 1; meta < 0: -((cid | (count-1) << 20) + 1); 0:
  empty. None where the builder drops it (the device LBVH at width 16),
  and the frame then walks ``nodes8``.

The layout belongs to the table: every builder records the knobs it read
in ``cluster_size`` and ``wide_width``, and every walk, plain version and
kernel library takes it from the scene it is given.

Derived on the port's side, not a JAX table: ``cluster_counts`` i32[L],
each leaf's live-triangle count (``live_counts``), which the binary walk
reads to test only a leaf's live triangles.
"""

from __future__ import annotations

import dataclasses

import torch

TRI_STRIDE = 16           # floats per packed triangle
CLUSTER_ROW = 128         # floats per cluster table row
ROW_TRIS = CLUSTER_ROW // TRI_STRIDE     # triangle records per row (8)
CLUSTER_SIZES = (2, 4, 8)  # triangles per leaf (RAYTPU_CLUSTER)
WIDE_WIDTHS = (8, 16)      # children per wide node (RAYTPU_WIDE)
DEFAULT_LAYOUT = (8, 8)    # (cluster_size, wide_width)
LEAF_CID_BITS = 20        # wide leaf meta: cluster id bits, count above
LEAF_CID_MASK = (1 << LEAF_CID_BITS) - 1


def check_layout(cluster_size: int, wide_width: int) -> None:
    if cluster_size not in CLUSTER_SIZES or wide_width not in WIDE_WIDTHS:
        raise ValueError(f"layout ({cluster_size}, {wide_width}): cluster "
                         f"size must be one of {CLUSTER_SIZES} and wide "
                         f"width one of {WIDE_WIDTHS}")


def live_counts(clusters: torch.Tensor, cluster_size: int) -> torch.Tensor:
    """i32[L]: per leaf of ``cluster_size`` records, 1 + the index of its
    last record holding a nonzero float (0 for an all-zero leaf). The
    packers fill a leaf's first records and leave the rest all zero, so
    this is its live-triangle count; an all-zero record never hits (det
    0), so testing only these keeps the result of testing them all."""
    live = (clusters.reshape(-1, cluster_size, TRI_STRIDE) != 0).any(2)
    rank = torch.arange(1, cluster_size + 1, dtype=torch.int32,
                        device=clusters.device)
    return (live.to(torch.int32) * rank).amax(1).contiguous()


@dataclasses.dataclass
class FastScene:
    """Device-resident packed scene (tables above + host-side counts)."""

    nodes8: torch.Tensor     # f32[Mpad, 8]
    clusters: torch.Tensor   # f32[Rows, 128]
    num_nodes: int
    num_triangles: int
    nodes4: torch.Tensor | None = None   # f32[Rpad, 128] or None
    num_nodes4: int | None = None
    cluster_size: int = DEFAULT_LAYOUT[0]
    wide_width: int = DEFAULT_LAYOUT[1]
    cluster_counts: torch.Tensor = dataclasses.field(init=False)  # i32[L]

    def __post_init__(self):
        check_layout(self.cluster_size, self.wide_width)
        if (self.nodes4 is None) != (self.num_nodes4 is None):
            raise ValueError("nodes4 and num_nodes4 are both set or both "
                             "None")
        self.cluster_counts = live_counts(self.clusters, self.cluster_size)

    @property
    def layout(self) -> tuple[int, int]:
        """(cluster_size, wide_width)."""
        return self.cluster_size, self.wide_width

    @property
    def leaf_rows(self) -> torch.Tensor:
        """The cluster table as f32[L, cluster_size * 16], one leaf a
        row (a view)."""
        return self.clusters.view(-1, self.cluster_size * TRI_STRIDE)

    @property
    def node_rows(self) -> torch.Tensor:
        """The wide table as f32[N, wide_width * 16], one node a row (a
        view)."""
        return self.nodes4.view(-1, self.wide_width * 16)

    @property
    def device(self) -> torch.device:
        return self.nodes8.device

    def to(self, device) -> "FastScene":
        return dataclasses.replace(
            self, nodes8=self.nodes8.to(device),
            clusters=self.clusters.to(device),
            nodes4=None if self.nodes4 is None else self.nodes4.to(device))

    def bounds(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Scene min / max (the binary root box) as f32[3] tensors."""
        return self.nodes8[0, 0:3], self.nodes8[0, 3:6]
