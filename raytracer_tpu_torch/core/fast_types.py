"""Packed scene layout for the packet tracer, as torch tensors.

Same tables, byte for byte, as ``raytracer_tpu.core.fast_types`` at its
default layout knobs:

* ``nodes8`` f32[Mpad, 8]: binary pre-order nodes — bbox min(3) + max(3)
  + bitcast<i32> skip link + bitcast<i32> leaf cluster id (internal nodes:
  -(left child + 1)).
* ``clusters`` f32[Lpad, 128]: one leaf per row, 8 triangles x 16 floats
  (v0.xyz, e1.xyz, e2.xyz, albedo.rgb, material type, unit normal.xyz).
* ``nodes4`` f32[Rpad, 128]: the 8-wide collapse of the same tree, one
  node per row, 8 children x [min(3) max(3) meta pad(9)]. meta > 0:
  internal wide id + 1; meta < 0: -((cid | (count-1) << 20) + 1); 0: empty.

Derived on the port's side, not a JAX table: ``cluster_counts`` i32[Lpad],
each cluster's live-triangle count (``live_counts``), which the binary
walk reads to test only a leaf's live triangles.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracer_tpu_torch import knobs

CLUSTER_SIZE = 8          # triangles per leaf cluster
TRI_STRIDE = 16           # floats per packed triangle
CLUSTER_ROW = CLUSTER_SIZE * TRI_STRIDE  # 128
ROW_TRIS = CLUSTER_ROW // TRI_STRIDE     # triangles per cluster row
WIDE_WIDTH = 8            # children per wide-BVH node (one 128-float row)
LEAF_CID_BITS = 20        # wide leaf meta: cluster id bits, count above
LEAF_CID_MASK = (1 << LEAF_CID_BITS) - 1


def live_counts(clusters: torch.Tensor) -> torch.Tensor:
    """i32[L]: per cluster row, 1 + the index of its last triangle record
    holding a nonzero float (0 for an all-zero row). The packers fill a
    cluster's first records and leave the rest all zero, so this is its
    live-triangle count; an all-zero record never hits (det 0), so testing
    only these keeps the result of testing all 8."""
    live = (clusters.reshape(-1, CLUSTER_SIZE, TRI_STRIDE) != 0).any(2)
    rank = torch.arange(1, CLUSTER_SIZE + 1, dtype=torch.int32,
                        device=clusters.device)
    return (live.to(torch.int32) * rank).amax(1).contiguous()


@dataclasses.dataclass
class FastScene:
    """Device-resident packed scene (tables above + host-side counts)."""

    nodes8: torch.Tensor     # f32[Mpad, 8]
    clusters: torch.Tensor   # f32[Lpad, 128]
    nodes4: torch.Tensor     # f32[Rpad, 128]
    num_nodes: int
    num_triangles: int
    num_nodes4: int
    cluster_counts: torch.Tensor = dataclasses.field(init=False)  # i32[Lpad]

    def __post_init__(self):
        knobs.fixed("RAYTPU_CLUSTER", "RAYTPU_WIDE")
        self.cluster_counts = live_counts(self.clusters)

    @property
    def device(self) -> torch.device:
        return self.nodes4.device

    def to(self, device) -> "FastScene":
        return dataclasses.replace(
            self, nodes8=self.nodes8.to(device),
            clusters=self.clusters.to(device), nodes4=self.nodes4.to(device))

    def bounds(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Scene min / max (the binary root box) as f32[3] tensors."""
        return self.nodes8[0, 0:3], self.nodes8[0, 3:6]
