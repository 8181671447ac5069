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

``sort_key`` is one launch of the key kernel (``csrc/front.cu``) on CUDA
tensors and ``sort_key_plain`` on CPU tensors; kernel B's plain version
calls ``sort_key_plain`` itself.
"""

from __future__ import annotations

import ctypes

import torch

from raytracer_tpu_torch.kernels import cuda_build, launches

# The keys kernel B can emit (kernels/bounce.py), in the order of the
# C entry points' key_mode (csrc/bounce12.cu); any other mode is computed
# on the host after each round.
KERNEL_KEYS = ("cid", "pd5", "om9")
# The key kernel's modes (csrc/front.cu KeyMode); any other mode keys as
# oct_morton (3).
_MODE_IDS = {"om9": 0, "cid": 0, "pd5": 1, "pos": 2}


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


def sort_key_plain(ray_o, ray_d, alive, smin, smax, mode: str = "cid",
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


def sort_key(ray_o, ray_d, alive, smin, smax, mode: str = "cid",
             dead_bit: int = 31) -> torch.Tensor:
    """``sort_key_plain`` as one launch of the key kernel
    (``csrc/front.cu``) on CUDA tensors, ``sort_key_plain`` itself on CPU
    tensors; the same arguments (f32 [n] rows of ``ray_o`` / ``ray_d``,
    any strides; ``alive`` bool[n]; ``smin`` / ``smax`` f32[3]) and keys,
    bit for bit, at dead bit 30 (the keys kernel B carries: i32, they lie
    below 2**31) or 31 (u32 values in int64)."""
    if dead_bit not in (30, 31):
        raise ValueError(f"dead bit {dead_bit}: the keys take 30 or 31")
    out_dtype = torch.int32 if dead_bit == 30 else torch.int64
    dev = alive.device
    if not launches.on_card("sort_key", dev):
        return sort_key_plain(ray_o, ray_d, alive, smin, smax, mode,
                              dead_bit).to(out_dtype)
    n = alive.shape[0]
    rows = [ray_o[k] for k in range(3)] + [ray_d[k] for k in range(3)]
    if (alive.dtype != torch.bool or alive.shape != (n,)
            or any(r.dtype != torch.float32 or r.shape != (n,)
                   or r.device != dev for r in rows)
            or any(b.dtype != torch.float32 or b.shape != (3,)
                   or b.device != dev for b in (smin, smax))):
        raise ValueError(f"the rays must be f32[{n}] rows, alive bool[{n}] "
                         f"and the box f32[3], all on {dev}")
    rows += [alive, smin, smax]
    ptrs = (ctypes.c_void_p * len(rows))(*(r.data_ptr() for r in rows))
    strides = (ctypes.c_int64 * len(rows))(*(r.stride(0) for r in rows))
    out = torch.empty(n, dtype=out_dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_build.check(cuda_build.library().rt_sort_key(
        ptrs, strides, out.data_ptr(), n, _MODE_IDS.get(mode, 3), dead_bit,
        stream), "rt_sort_key")
    launches.launched("sort_key")
    return out
