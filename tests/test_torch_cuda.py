"""Kernels against their plain versions on the card (marked ``cuda``).

Skipped without an NVIDIA GPU. On a machine with one (and no JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Each kernel must agree with its plain version bit for bit: both run the
same per-ray algorithm with the same IEEE arithmetic (no FMA contraction).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def scene():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc, triton)")
    from raytracer_tpu_torch.scene.builder import \
        build_fast_scene_from_arrays
    from raytracer_tpu_torch.utils import assets

    verts = assets.make_terrain(n=48, extent=30.0)
    r = np.random.default_rng(5)
    mats = np.zeros((verts.shape[0], 4), np.float32)
    mats[:, 0:3] = r.uniform(0.2, 0.9, (verts.shape[0], 3))
    mats[:, 3] = r.integers(0, 4, verts.shape[0])
    return build_fast_scene_from_arrays(verts, mats, device="cuda")


def _rays(n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    o = (torch.rand((3, n), generator=g, device="cuda") - 0.5) * 60.0
    o[1] = o[1].abs() + 2.0
    d = torch.randn((3, n), generator=g, device="cuda")
    d[0, : n // 8] = 0.0
    d = d / d.norm(dim=0)
    return o, d


def test_trace4_kernel_matches_plain(scene):
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.kernels.trace import trace4, trace4_plain

    o, d = _rays(8192, 1)
    rays = torch.cat([o, d]).contiguous()
    active = torch.arange(8192, device="cuda") % 7 != 0
    cfg = RenderConfig()
    got = trace4(scene, rays, active, cfg)
    want = trace4_plain(scene, rays, active, cfg)
    assert torch.equal(got, want)
    assert (got[0] < cfg.t_max).float().mean() > 0.2


def test_bounce12_kernel_matches_plain(scene):
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.kernels.bounce import (bounce12,
                                                    bounce12_plain,
                                                    pack_state)

    n = 8192
    o, d = _rays(n, 2)
    g = torch.Generator(device="cuda").manual_seed(3)
    a = torch.rand((3, n), generator=g, device="cuda")
    seed = torch.randint(0, 2 ** 32, (n,), generator=g, device="cuda")
    alive = torch.rand(n, generator=g, device="cuda") < 0.8
    budget = torch.randint(0, 3, (n,), generator=g, device="cuda",
                           dtype=torch.int32)
    state = pack_state(tuple(o), tuple(d), tuple(a), seed, alive, budget,
                       torch.arange(n, device="cuda"))
    for bcap in (1, 3):
        out_k, key_k, cnt_k = bounce12(scene, state, bcap, True,
                                       RenderConfig())
        out_p, key_p, cnt_p = bounce12_plain(scene, state, bcap, True,
                                             RenderConfig())
        assert torch.equal(out_k, out_p) and torch.equal(key_k, key_p)
        assert torch.equal(cnt_k, cnt_p)


def test_trace2_kernel_matches_plain(scene):
    """Kernel 5 (binary walk) with the flip on and off."""
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.kernels.trace import trace2, trace2_plain

    o, d = _rays(8192, 6)
    rays = torch.cat([o, d]).contiguous()
    active = torch.arange(8192, device="cuda") % 5 != 0
    for shading in ("path", "fixed_light"):
        cfg = RenderConfig(shading=shading)
        got = trace2(scene, rays, active, cfg)
        want = trace2_plain(scene, rays, active, cfg)
        assert torch.equal(got, want), shading
        assert (got[0] < cfg.t_max).float().mean() > 0.1


def test_trace4_kernel_matches_plain_without_flip(scene):
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.kernels.trace import trace4, trace4_plain

    o, d = _rays(8192, 7)
    rays = torch.cat([o, d]).contiguous()
    active = torch.ones(8192, dtype=torch.bool, device="cuda")
    cfg = RenderConfig(shading="fixed_light")
    assert torch.equal(trace4(scene, rays, active, cfg),
                       trace4_plain(scene, rays, active, cfg))


def _color_state(n, seed):
    from raytracer_tpu_torch.kernels.bounce import pack_state

    o, d = _rays(n, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    c = torch.rand((3, n), generator=g, device="cuda") * 0.2
    a = torch.rand((3, n), generator=g, device="cuda")
    rnd = torch.randint(0, 2 ** 32, (n,), generator=g, device="cuda")
    alive = torch.rand(n, generator=g, device="cuda") < 0.8
    budget = torch.randint(0, 4, (n,), generator=g, device="cuda",
                           dtype=torch.int32)
    return pack_state(tuple(o), tuple(d), tuple(a), rnd, alive, budget,
                      torch.arange(n, device="cuda"), color=tuple(c))


def test_bounce15_kernel_matches_plain(scene):
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.kernels.bounce import bounce15, bounce15_plain

    state = _color_state(8192, 8)
    for bcap in (1, 3, 9):
        out_k, key_k, cnt_k = bounce15(scene, state, bcap, True,
                                       RenderConfig())
        out_p, key_p, cnt_p = bounce15_plain(scene, state, bcap, True,
                                             RenderConfig())
        assert torch.equal(out_k, out_p) and torch.equal(key_k, key_p)
        assert torch.equal(cnt_k, cnt_p)


def test_bounce_packed_kernel_matches_plain(scene):
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.kernels.bounce import (ROW_ALIVE, ROW_PIX,
                                                    ROW_SEED, bounce_packed,
                                                    bounce_packed_plain)

    state = _color_state(8192, 9)
    sf = torch.cat([state[0:12].view(torch.float32),
                    state[ROW_ALIVE].float()[None]]).contiguous()
    si = torch.stack([state[ROW_SEED], state[ROW_PIX],
                      state[ROW_PIX] * 3]).contiguous()
    for bcap in (1, 2):
        got = bounce_packed(scene, sf, si, bcap, False, RenderConfig())
        want = bounce_packed_plain(scene, sf, si, bcap, False,
                                   RenderConfig())
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert torch.equal(got[1][1:], si[1:])


def test_tonemap_kernel_matches_plain(scene):
    from raytracer_tpu_torch.kernels.tonemap import (tonemap_accumulate,
                                                     tonemap_plain)

    g = torch.Generator(device="cuda").manual_seed(4)
    acc = torch.rand((72, 128, 3), generator=g, device="cuda") * 1.5
    smp = torch.rand((72, 128, 3), generator=g, device="cuda") * 1.5
    for fc, ex in ((0, 0.0), (3, 0.5), (7, -1.0)):
        acc_k, img_k = tonemap_accumulate(acc.clone(), smp, fc, ex)
        acc_p, img_p = tonemap_plain(acc.clone(), smp, fc, ex)
        assert torch.equal(acc_k, acc_p) and torch.equal(img_k, img_p)


def test_walk_kernels_at_the_stack_limit(scene):
    """A 36-level tree whose walk pushes 246 stack entries (need 253 of
    the 256 slots in local memory). Kernels A and B stay bit-equal to
    their plain versions."""
    from raytracer_tpu_torch.bvh.bvh4 import nodes4_stack_need
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.kernels import cuda_build
    from raytracer_tpu_torch.kernels.bounce import (bounce12,
                                                    bounce12_plain,
                                                    pack_state)
    from raytracer_tpu_torch.kernels.trace import trace4, trace4_plain
    from raytracer_tpu_torch.scene import presets

    n = 4096
    deep, rays = presets.stack_limit_scene(n, device="cuda")
    assert nodes4_stack_need(deep.nodes4.cpu().numpy()) == 253
    for name in ("trace4", "bounce12"):
        assert cuda_build.kernel_attrs(name)["local_bytes"] >= 4 * 256
    cfg = RenderConfig()
    active = torch.arange(n, device="cuda") % 5 != 0
    got = trace4(deep, rays, active, cfg)
    assert torch.equal(got, trace4_plain(deep, rays, active, cfg))
    assert (got[0] < cfg.t_max).float().mean() > 0.5
    g = torch.Generator(device="cuda").manual_seed(21)
    seed = torch.randint(0, 2 ** 32, (n,), generator=g, device="cuda")
    state = pack_state(tuple(rays[0:3]), tuple(rays[3:6]),
                       (torch.ones(n, device="cuda"),) * 3, seed, active, 3,
                       torch.arange(n, device="cuda"))
    for bcap in (1, 2):
        out_k = bounce12(deep, state, bcap, True, cfg)
        out_p = bounce12_plain(deep, state, bcap, True, cfg)
        for k, p in zip(out_k, out_p):
            assert torch.equal(k, p)
