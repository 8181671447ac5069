"""Sort keys of the sorted rounds: the JAX package's
``raytracer_tpu/kernels/wavefront.sort_key`` (``RAYTPU_SORT_KEY``).

Every key is a u32 value held in int64 (torch has no uint32 arithmetic on
the CPU), with the dead flag at ``dead_bit``: 31 for the keys computed on
the host, 30 for the keys kernel B emits (``kernels/bounce.py``, carried as
i32 so that an ascending argsort still puts dead rays last). The modes:

* ``pd5``: origin and direction, 5 bits a channel, bit-interleaved;
* ``om9`` and ``cid``: the 9-bit Morton code of the origin, then the
  direction octant (``cid`` is the winner-cluster key that kernel B
  emits; on the host it takes this form, as in the JAX package);
* ``pos``: the 10-bit Morton code of the origin alone;
* ``oct_morton``, and any other value: the octant above a 9-bit Morton
  code.

Origins are placed against the scene's root box (``smin``, ``smax``, f32[3]
tensors: no host read). A coordinate is clipped, then truncated toward
zero; a NaN gives 0, as XLA's float to integer conversion does.
"""

from __future__ import annotations

import torch

# The keys kernel B can emit (kernels/bounce.py), in the order of the
# C entry points' key_mode (csrc/bounce12.cu); any other mode is computed
# on the host after each round.
KERNEL_KEYS = ("cid", "pd5", "om9")


def _part1by2(v):
    """Spread the low 10 bits of v to every 3rd bit."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _clip_trunc(x: torch.Tensor, hi: float) -> torch.Tensor:
    """``jnp.clip(x, 0, hi).astype(uint32)``, NaN -> 0, in int64."""
    q = torch.nan_to_num(torch.clamp(x, 0.0, hi), nan=0.0)
    return q.to(torch.int64)


def _box(o, smin, smax, ax: int, hi: float) -> torch.Tensor:
    span = torch.clamp_min(smax[ax] - smin[ax], 1e-6)
    return _clip_trunc((o[ax] - smin[ax]) / span * hi, hi)


def sort_key(ray_o, ray_d, alive, smin, smax, mode: str = "cid",
             dead_bit: int = 31) -> torch.Tensor:
    """Round key u32 values in int64, bit-equal to the JAX ``sort_key`` of
    ``mode`` at ``dead_bit`` (module docstring)."""
    dead = (~alive).to(torch.int64) << dead_bit
    if mode == "pd5":
        chans = [_box(ray_o, smin, smax, ax, 31.0) for ax in range(3)]
        chans += [_clip_trunc((ray_d[ax] + 1.0) * 15.5, 31.0)
                  for ax in range(3)]
        code = torch.zeros_like(dead)
        for b in range(5):
            for i, c in enumerate(chans):
                code = code | (((c >> b) & 1) << (6 * b + i))
        return dead | code
    bits = 10 if mode == "pos" else 9
    q_max = float((1 << bits) - 1)
    morton = torch.zeros_like(dead)
    for ax in range(3):
        morton = morton | (_part1by2(_box(ray_o, smin, smax, ax, q_max))
                           << ax)
    if mode == "pos":
        return dead | (morton & ((1 << 30) - 1))
    octant = ((ray_d[0] > 0).to(torch.int64)
              | ((ray_d[1] > 0).to(torch.int64) << 1)
              | ((ray_d[2] > 0).to(torch.int64) << 2))
    morton = morton & ((1 << 27) - 1)
    if mode in ("om9", "cid"):
        return dead | (morton << 3) | octant
    return dead | (octant << 28) | morton
