"""PCG hash RNG with per-ray masked advancement (torch).

Bit-equal to ``raytracer_tpu.kernels.rng``. Seeds are u32 values carried
in int64 tensors and masked with ``& 0xFFFFFFFF`` after every wrapping
operation: torch on the CPU has no uint32 add, shift or compare.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
REJECTION_ROUNDS = 24  # P(exhaust) = (1 - pi/6)^24 ~ 2e-8 per draw


def pcg(v: torch.Tensor) -> torch.Tensor:
    """The PCG output hash (compute_dynamic_ray.comp:52-56), u32 -> u32
    in int64."""
    state = (v * 747796405 + 2891336453) & M32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & M32
    return (word >> 22) ^ word


def to_unit_float(seed: torch.Tensor) -> torch.Tensor:
    """float(u32) / float(0xFFFFFFFF) (both round to nearest f32)."""
    return seed.to(torch.float32) / 4294967295.0


def random_float(seed: torch.Tensor, active: torch.Tensor):
    """One masked draw -> (new_seed, value)."""
    new_seed = torch.where(active, pcg(seed), seed)
    return new_seed, to_unit_float(new_seed)


def random_vec3(seed, active):
    seed, x = random_float(seed, active)
    seed, y = random_float(seed, active)
    seed, z = random_float(seed, active)
    return seed, (x, y, z)


def random_vec3_in_unit_sphere(seed, active, draws: list | None = None):
    """Masked, bounded rejection sampling of a point in the unit ball:
    3 discarded draws, then 3 draws per round for REJECTION_ROUNDS rounds
    (an exhausted lane returns (0, 0, 0)). ``draws``: a list that gets
    the count of each call's draws (0-d tensors, no host read)."""
    if draws is not None:
        draws.append(3 * active.sum())
    seed, _ = random_vec3(seed, active)
    zero = torch.zeros(active.shape, dtype=torch.float32,
                       device=active.device)
    px, py, pz = zero, zero, zero
    accepted = ~active
    for _ in range(REJECTION_ROUNDS):
        need = active & ~accepted
        if draws is not None:
            draws.append(3 * need.sum())
        seed, (vx, vy, vz) = random_vec3(seed, need)
        cx = vx * 2.0 - 1.0
        cy = vy * 2.0 - 1.0
        cz = vz * 2.0 - 1.0
        ok = cx * cx + cy * cy + cz * cz < 1.0
        take = need & ok
        px = torch.where(take, cx, px)
        py = torch.where(take, cy, py)
        pz = torch.where(take, cz, pz)
        accepted = accepted | take
    return seed, (px, py, pz)
