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
        pytest.skip("needs an NVIDIA GPU (and nvcc)")
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


@pytest.mark.parametrize("coherent", [False, True])
def test_trace2_kernel_matches_plain(scene, coherent):
    """Kernel 5 (binary walk), per-ray and warp design, with the flip on
    and off, on incoherent rays."""
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.kernels.trace import trace2, trace2_plain

    o, d = _rays(8192, 6)
    rays = torch.cat([o, d]).contiguous()
    active = torch.arange(8192, device="cuda") % 5 != 0
    for shading in ("path", "fixed_light"):
        cfg = RenderConfig(shading=shading)
        got = trace2(scene, rays, active, cfg, coherent)
        want = trace2_plain(scene, rays, active, cfg)
        assert torch.equal(got, want), shading
        assert (got[0] < cfg.t_max).float().mean() > 0.1


@pytest.mark.parametrize("coherent", [False, True])
def test_trace2_kernel_matches_plain_on_a_sorted_round(scene, coherent):
    """Kernel 5 on a round as the split engine hands it over: rays sorted
    by the host om9 key, the dead (inactive) ones last."""
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.kernels.trace import trace2, trace2_plain
    from raytracer_tpu_torch.kernels.wavefront import sort_key

    n = 8192
    o, d = _rays(n, 10)
    g = torch.Generator(device="cuda").manual_seed(11)
    alive = torch.rand(n, generator=g, device="cuda") < 0.7
    order = torch.argsort(sort_key(tuple(o), tuple(d), alive,
                                   *scene.bounds()), stable=True)
    rays = torch.cat([o, d])[:, order].contiguous()
    active = alive[order]
    cfg = RenderConfig()
    got = trace2(scene, rays, active, cfg, coherent)
    assert torch.equal(got, trace2_plain(scene, rays, active, cfg))
    assert (got[0] < cfg.t_max).float().mean() > 0.1


@pytest.mark.parametrize("coherent", [False, True])
def test_trace2_kernel_on_the_empty_scene(coherent):
    """The one-node all-miss table: every lane misses."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc)")
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.kernels.trace import trace2, trace2_plain
    from raytracer_tpu_torch.scene.builder import \
        build_fast_scene_from_arrays

    empty = build_fast_scene_from_arrays(np.zeros((0, 3, 3), np.float32),
                                         np.zeros((0, 4), np.float32),
                                         device="cuda")
    assert empty.num_nodes == 1
    o, d = _rays(1000, 12)
    rays = torch.cat([o, d]).contiguous()
    active = torch.arange(1000, device="cuda") % 3 != 0
    cfg = RenderConfig()
    got = trace2(empty, rays, active, cfg, coherent)
    assert torch.equal(got, trace2_plain(empty, rays, active, cfg))
    assert (got[0] == cfg.t_max).all() and (got[1:] == 0).all()


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


def test_bounce15_pmega_call_matches_plain(scene):
    """The pmega call (bcap 9, persistent warps) on a width that is no
    multiple of 32 or 128, with per-ray budgets 0-9 mixed: state, key and
    counts bit-equal."""
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.kernels.bounce import (ROW_BUDGET, bounce15,
                                                    bounce15_plain)

    n = 8192 + 37
    state = _color_state(n, 13)
    g = torch.Generator(device="cuda").manual_seed(14)
    state[ROW_BUDGET] = torch.randint(0, 10, (n,), generator=g,
                                      device="cuda", dtype=torch.int32)
    cfg = RenderConfig()
    got = bounce15(scene, state, cfg.max_bounces - 1, True, cfg)
    want = bounce15_plain(scene, state, cfg.max_bounces - 1, True, cfg)
    for k, p in zip(got, want):
        assert torch.equal(k, p)
    assert got[0].shape == state.shape and got[2][0] > n // 2


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


def _packed(n, seed, si_rows, dead=False):
    from raytracer_tpu_torch.kernels.bounce import (ROW_ALIVE, ROW_PIX,
                                                    ROW_SEED)

    state = _color_state(n, seed)
    alive = torch.zeros(n, device="cuda") if dead else \
        state[ROW_ALIVE].float()
    sf = torch.cat([state[0:12].view(torch.float32), alive[None]])
    si = torch.stack([state[ROW_SEED]]
                     + [state[ROW_PIX] * (k + 1) for k in range(si_rows - 1)])
    return sf.contiguous(), si.contiguous()


@pytest.mark.parametrize("width", [1, 31, 33, 129, 307200])
def test_bounce_packed_kernel_matches_plain_at_widths(scene, width):
    """The packed round at widths around a warp and a block and at the
    720p band's full round, with 2 and 3 si rows and an all-dead state:
    state, key and counts bit-equal."""
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.kernels.bounce import (bounce_packed,
                                                    bounce_packed_plain)

    cfg = RenderConfig()
    for si_rows, dead in ((2, False), (3, False), (2, True)):
        sf, si = _packed(width, 40 + si_rows, si_rows, dead)
        got = bounce_packed(scene, sf, si, 1, True, cfg)
        want = bounce_packed_plain(scene, sf, si, 1, True, cfg)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (si_rows, dead)
        assert torch.equal(got[1][1:], si[1:])
        if dead:
            assert got[3].tolist() == [0, 0]


def test_bounce_packed_counting_build(scene):
    """The counting build returns the kernel's results, walk tallies and a
    timer pair per block."""
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.kernels.bounce import (bounce_packed,
                                                    bounce_packed_count)

    cfg = RenderConfig()
    sf, si = _packed(8192 + 5, 50, 2)
    *got, tallies, times = bounce_packed_count(scene, sf, si, 1, True, cfg)
    for g, w in zip(got, bounce_packed(scene, sf, si, 1, True, cfg)):
        assert torch.equal(g, w)
    vt, vl, lt, ll = tallies.tolist()
    assert 0 < vt <= vl <= 32 * vt and 0 < lt <= ll <= 32 * lt
    assert times.shape[0] >= 1 and (times[:, 1] >= times[:, 0]).all()


@pytest.mark.parametrize("hw", [(720, 1280), (128, 256), (37, 51)])
def test_tonemap_kernel_matches_plain(scene, hw):
    """The tonemap on a planar band sum at 1280x720, 256x128 and an H*W
    that is no multiple of 4 (the scalar path): accumulator and image
    bit-equal, with spp 1 and 2, fc 0 and > 0, and a pixel at the
    half-to-even point."""
    from raytracer_tpu_torch.kernels.tonemap import (tonemap_accumulate,
                                                     tonemap_plain)

    h, w = hw
    g = torch.Generator(device="cuda").manual_seed(4)
    acc = torch.rand((h, w, 3), generator=g, device="cuda") * 1.5
    total = torch.rand((3, h * w), generator=g, device="cuda") * 3.0
    total[:, 0] = -0.5
    for spp, fc, ex in ((1, 0, 0.0), (2, 3, 0.5), (2, 7, -1.0)):
        total[:, 1] = 0.25 * spp
        fc_t = torch.tensor(fc, dtype=torch.int32, device="cuda")
        ex_t = torch.tensor(ex, dtype=torch.float32, device="cuda")
        acc_k, img_k = tonemap_accumulate(acc.clone(), total, spp, fc_t,
                                          ex_t)
        acc_p, img_p = tonemap_plain(acc.clone(), total, spp, fc_t, ex_t)
        assert torch.equal(acc_k.view(torch.int32), acc_p.view(torch.int32))
        assert torch.equal(img_k, img_p)
        if fc == 0:
            assert (img_k.view(-1, 3)[1] == 128).all()


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
    assert nodes4_stack_need(deep.nodes4.cpu().numpy(), 8) == 253
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


def test_chain_equals_sequential_frames_on_the_card(scene):
    """render_chain(k=8) leaves the accumulator and the u8 image
    bit-equal to 8 render calls, through the kernels."""
    from raytracer_tpu_torch.core.camera import default_camera
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.engine.renderer import Renderer
    from raytracer_tpu_torch.kernels import launches

    cfg = RenderConfig(width=256, height=128, band_rays=16384)
    cam = default_camera(cfg.width, cfg.height)
    r = Renderer(cfg)
    accum = None
    for fc in range(8):
        cam.frame_count = fc
        accum, image, _ = r.render(scene, cam.uniforms(), accum)
    cam.frame_count = 0
    launches.reset()
    c_accum, c_image, stats = r.render_chain(scene, cam.uniforms(), None, 8)
    assert launches.kernel["tonemap"] == 8 and not launches.plain
    assert torch.equal(c_accum.view(torch.int32), accum.view(torch.int32))
    assert torch.equal(c_image, image) and stats["samples"] == 8


def test_preset_built_on_the_card_equals_its_cpu_tables():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc)")
    from raytracer_tpu_torch.scene.builder import build_fast_scene
    from raytracer_tpu_torch.scene.presets import config2_sphere_light

    snap = config2_sphere_light().scene.create_snapshot()
    gpu = build_fast_scene(snap)
    cpu = build_fast_scene(snap, device="cpu")
    assert gpu.device.type == "cuda"
    for name in ("nodes8", "clusters", "nodes4", "cluster_counts"):
        assert getattr(gpu, name).cpu().numpy().tobytes() == \
            getattr(cpu, name).numpy().tobytes(), name
    assert (gpu.num_nodes, gpu.num_triangles, gpu.num_nodes4) == \
        (cpu.num_nodes, cpu.num_triangles, cpu.num_nodes4)


@pytest.mark.parametrize("mode", ["instanced", "refit", "lbvh",
                                  "lbvh_ploc"])
def test_device_builder_on_the_card_equals_its_cpu_build(monkeypatch,
                                                        tmp_path, mode):
    """Each live-edit build on the card (``lbvh_ploc``: the LBVH route
    with the device PLOC tree) against the same build on the CPU (0
    differing link / meta words, floats within 2 ulp), then kernels A and
    trace2 on the card-built tables against their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc)")
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.kernels.trace import (trace2, trace2_plain,
                                                   trace4, trace4_plain)
    from raytracer_tpu_torch.scene.device_builder import DeviceSceneBuilder
    from raytracer_tpu_torch.scene.scene import ModelInstance
    from raytracer_tpu_torch.utils import assets

    build = mode.split("_")[0]
    monkeypatch.setenv("RAYTPU_DEVICE_BUILD", build)
    if mode == "lbvh_ploc":
        monkeypatch.setenv("RAYTPU_DEVICE_TREE", "ploc")
    path = str(tmp_path / "terrain.obj")
    assets.write_obj(path, assets.make_terrain(n=48, extent=30.0))
    insts = [ModelInstance(path, position=(-10, 0, 0), color=(0.7, 0.6, 0.5)),
             ModelInstance(path, position=(12, 2, 3), scale=(-1, 1, 1),
                           material_type=1.0)]
    card = DeviceSceneBuilder()
    got = card.build(insts)
    cpu = DeviceSceneBuilder("cpu")
    want = cpu.build(insts)
    assert card.last_mode == cpu.last_mode == build
    assert (got.num_nodes, got.num_nodes4) == (want.num_nodes,
                                              want.num_nodes4)
    for name in ("nodes8", "nodes4", "clusters"):
        a = getattr(got, name).cpu().view(torch.int32).long()
        b = getattr(want, name).view(torch.int32).long()
        links = {"nodes8": (slice(None), slice(6, 8)),
                 "nodes4": (slice(None), slice(6, 128, 16))}.get(name)
        if links is not None:
            assert torch.equal(a[links], b[links]), name
        assert (a - b).abs().max().item() <= 2, name

    o, d = _rays(8192, 9)
    rays = torch.cat([o, d]).contiguous()
    active = torch.ones(8192, dtype=torch.bool, device="cuda")
    cfg = RenderConfig()
    assert torch.equal(trace4(got, rays, active, cfg),
                       trace4_plain(got, rays, active, cfg))
    for coherent in (False, True):
        assert torch.equal(trace2(got, rays, active, cfg, coherent),
                           trace2_plain(got, rays, active, cfg))


MESH_CFG = dict(width=128, height=64, max_bounces=4, band_rays=4096)


def _mesh_frame(mesh):
    """A rank of the two-rank mesh: the terrain scene at MESH_CFG, frame
    0 -> (u8 frame, rays) as numpy on rank 0."""
    from raytracer_tpu_torch.core.camera import default_camera
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.kernels import launches
    from raytracer_tpu_torch.parallel.sharding import MeshRenderer
    from raytracer_tpu_torch.scene.builder import \
        build_fast_scene_from_arrays
    from raytracer_tpu_torch.utils import assets

    verts = assets.make_terrain(n=48, extent=30.0)
    mats = np.full((verts.shape[0], 4), 0.6, np.float32)
    mats[:, 3] = 0.0
    scene = build_fast_scene_from_arrays(verts, mats, device=mesh.device)
    cfg = RenderConfig(**MESH_CFG)
    launches.reset()
    _, image, stats = MeshRenderer(cfg, mesh).render(
        scene, default_camera(cfg.width, cfg.height).uniforms(
            device=mesh.device))
    assert launches.kernel["bounce12"] > 0 and not launches.plain
    return image.cpu().numpy(), int(stats["rays_traced"])


def test_two_rank_gloo_mesh_on_one_card_equals_one_device():
    """Two ranks on cuda:0 over gloo against one device: u8 frame and
    rays equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc)")
    from raytracer_tpu_torch.core.camera import default_camera
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.engine.renderer import Renderer
    from raytracer_tpu_torch.parallel.sharding import launch
    from raytracer_tpu_torch.scene.builder import \
        build_fast_scene_from_arrays
    from raytracer_tpu_torch.utils import assets

    run = launch(_mesh_frame, 2, devices=["cuda:0"] * 2, timeout=300)
    assert run.backend == "gloo"
    verts = assets.make_terrain(n=48, extent=30.0)
    mats = np.full((verts.shape[0], 4), 0.6, np.float32)
    mats[:, 3] = 0.0
    scene = build_fast_scene_from_arrays(verts, mats, device="cuda")
    cfg = RenderConfig(**MESH_CFG)
    _, image, stats = Renderer(cfg).render(
        scene, default_camera(cfg.width, cfg.height).uniforms())
    got, rays = run.results[0]
    assert got.tobytes() == image.cpu().numpy().tobytes()
    assert rays == int(stats["rays_traced"])


def _mega_state(n, seed, dead=False):
    """A random megakernel state of n rays: (ray_o, ray_d, color, atten,
    seed, alive, pix), a permutation of pixel ids."""
    o, d = _rays(n, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 100)
    color = torch.rand((3, n), generator=g, device="cuda") * 0.5
    atten = torch.rand((3, n), generator=g, device="cuda")
    seeds = torch.randint(0, 2 ** 32, (n,), generator=g, device="cuda")
    alive = torch.rand(n, generator=g, device="cuda") < 0.85
    if dead:
        alive[:] = False
    pix = torch.randperm(n, generator=g, device="cuda")
    return (tuple(o), tuple(d), tuple(color), tuple(atten), seeds, alive,
            pix)


def _resident_lanes(layout=(8, 8)) -> int:
    """The threads of the mega kernel that stay resident on the card (its
    persistent launch): blocks per SM x SMs x threads a block."""
    from raytracer_tpu_torch.kernels import cuda_build

    attrs = cuda_build.kernel_attrs("mega", layout)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return attrs["blocks_per_sm"] * sms * attrs["threads"]


@pytest.mark.parametrize("start", [0, 1])
@pytest.mark.parametrize("width", [1, 31, 33, 129, 307200, "dead", "sparse",
                                   "resident-1", "resident", "resident+1",
                                   "bounces1", "drop"])
def test_mega_kernel_matches_plain(scene, width, start):
    """The mega kernel against the plain megakernel (width levels and
    all): 0 differing colour bytes, equal rays traced, and the same bytes
    from a second call (the rays each lane fetches vary, the result may
    not). ``dead`` is a 129-ray state with no live ray (every colour
    deposited as it came); ``sparse`` 8197 rays, one live in every 32;
    ``resident`` as many rays as the persistent launch has resident
    threads (``-1``, ``+1``: one fewer, one more); ``bounces1`` 4097 rays
    at ``max_bounces`` 1 (the rest run the default 10); ``drop`` 8195 rays
    into ``n_out`` = P - 1000 cells, pixel ids shifted by -500, so the
    negative ones and those >= ``n_out`` are dropped (the plain version
    drops ids >= ``n_out``: it gets ``n_out`` for the negative ones)."""
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.kernels import launches
    from raytracer_tpu_torch.kernels.mega import mega, mega_plain

    if isinstance(width, int):
        n = width
    elif width.startswith("resident"):
        n = _resident_lanes() + {"resident-1": -1, "resident": 0,
                                 "resident+1": 1}[width]
    else:
        n = {"dead": 129, "sparse": 8197, "bounces1": 4097,
             "drop": 8195}[width]
    o, d, c, a, s, alive, pix = _mega_state(n, 7 + n, width == "dead")
    if width == "sparse":
        alive = torch.arange(n, device="cuda") % 32 == 5
    cfg = RenderConfig(max_bounces=1 if width == "bounces1" else 10)
    n_out, pix_plain = None, pix
    if width == "drop":
        n_out = n - 1000
        pix = pix - 500
        pix_plain = torch.where(pix < 0, n_out, pix)
        assert (pix < 0).any() and (pix >= n_out).any()
    launches.reset()
    got, rays = mega(scene, o, d, c, a, s, alive, True, cfg, start, pix,
                     n_out)
    assert launches.kernel["mega"] == 1 and not launches.plain
    again, rays2 = mega(scene, o, d, c, a, s, alive, True, cfg, start, pix,
                        n_out)
    want, want_rays = mega_plain(scene, o, d, c, a, s, alive, True, cfg,
                                 start, pix_plain, n_out)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(again.view(torch.int32), got.view(torch.int32))
    assert int(rays) == int(rays2) == int(want_rays) >= int(alive.sum())
    if width == "dead":
        assert int(rays) == 0
        assert torch.equal(got[:, pix], torch.stack(c))


def test_mega_count_matches_kernel(scene):
    """The mega kernel's counting build under both schedules (the
    kernel's, and one ray a thread walking a whole bounce at a time):
    the kernel's colour bytes and rays traced, tallies within their
    bounds, one timer span a launched block."""
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.kernels.mega import mega, mega_count

    n = 20000 + 7
    o, d, c, a, s, alive, pix = _mega_state(n, 21)
    args = (scene, o, d, c, a, s, alive, True, RenderConfig(), 0, pix)
    got, rays = mega(*args)
    for schedule in (0, 1):
        out, r, tallies, times = mega_count(*args, schedule=schedule)
        assert torch.equal(out.view(torch.int32), got.view(torch.int32))
        assert int(r) == int(rays)
        vt, vl, lt, ll = (int(x) for x in tallies)
        assert 0 < vt <= vl <= 32 * vt and 0 < lt <= ll <= 32 * lt
        assert 0 < times.shape[0] <= -(-n // 128)
        assert bool((times[:, 1] >= times[:, 0]).all())


# Path -> (knobs, kernels it launches, fixed-light tier, ties allowed).
XLA_PATHS = {
    "bounce_mega": ({"RAYTPU_BOUNCE": "mega"},
                    {"raygen", "trace4", "shade", "mega"}, False, False),
    "b0_mega": ({"RAYTPU_B0": "mega"}, {"mega"}, False, False),
    "b0_packet": ({"RAYTPU_B0": "packet"}, {"trace2_warp", "shade", "mega"},
                  False, False),
    "b0_pwave": ({"RAYTPU_B0": "pwave"}, {"raygen", "sort_key", "bounce12"},
                 False, True),
    "c12_b0_mega": ({"RAYTPU_B0": "mega"}, {"trace2"}, True, False),
}


@pytest.mark.parametrize("path", list(XLA_PATHS))
def test_xla_path_frame_matches_plain(scene, monkeypatch, path):
    """A 256x128 frame of each XLA-path knob through the kernels and
    through the plain versions: 0 differing pixels (``b0_pwave``: kernel
    B's equal-t tie lanes, at most 0.5% of the pixels)."""
    from raytracer_tpu_torch.core.camera import default_camera
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.engine.renderer import Renderer
    from raytracer_tpu_torch.kernels import launches

    env, kernels, c12, ties = XLA_PATHS[path]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = RenderConfig(width=256, height=128, band_rays=16384,
                       **(dict(max_bounces=1, shading="fixed_light")
                          if c12 else {}))
    uni = default_camera(cfg.width, cfg.height).uniforms()
    launches.reset()
    acc_k, img_k, st_k = Renderer(cfg).render(scene, uni)
    assert set(launches.kernel) == kernels | {"tonemap"}
    assert not launches.plain
    launches.reset()
    with launches.plain_versions():
        acc_p, img_p, st_p = Renderer(cfg).render(scene, uni)
    assert not launches.kernel
    assert set(launches.plain) == kernels | {"tonemap"}
    differ = int((img_k != img_p).any(-1).sum())
    if ties:
        assert differ <= 0.005 * cfg.width * cfg.height
    else:
        assert differ == 0
        assert torch.equal(acc_k.view(torch.int32), acc_p.view(torch.int32))
        assert int(st_k["rays_traced"]) == int(st_p["rays_traced"])


def _round_state(n, seed, color):
    """A round state with origins around and outside the root box (the
    pd5 / om9 keys clip), 20% dead, budgets 0-3."""
    from raytracer_tpu_torch.kernels.bounce import pack_state

    o, d = _rays(n, seed)
    o[:, : n // 16] *= 3.0
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    a = torch.rand((3, n), generator=g, device="cuda")
    c = torch.rand((3, n), generator=g, device="cuda") * 0.2
    s = torch.randint(0, 2 ** 32, (n,), generator=g, device="cuda")
    alive = torch.rand(n, generator=g, device="cuda") < 0.8
    budget = torch.randint(0, 4, (n,), generator=g, device="cuda",
                           dtype=torch.int32)
    return pack_state(tuple(o), tuple(d), tuple(a), s, alive, budget,
                      torch.arange(n, device="cuda"),
                      color=tuple(c) if color else None)


# Kernel B's builds of the sorted rounds' knobs: (wrapper, key, ordered).
BUILDS = [("bounce12", "pd5", True), ("bounce12", "om9", True),
          ("bounce12", "cid", False), ("bounce12", "pd5", False),
          ("bounce15", "pd5", True), ("bounce15", "om9", True),
          ("bounce15", "cid", False), ("bounce15", "om9", False),
          ("bounce_packed", "pd5", True), ("bounce_packed", "om9", True)]


@pytest.mark.parametrize("build", BUILDS,
                         ids=["_".join(map(str, b)) for b in BUILDS])
def test_bounce_build_kernel_matches_plain(scene, build):
    """Each key and walk-order build of kernel B against its plain version
    at bcap 1 and 3 (``bounce15`` at bcap 3: the persistent warps of the
    pmega call): 0 differing bytes in state, key and counts, and the
    launch booked under the build's name."""
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.kernels import bounce, launches

    kernel, key_mode, ordered = build
    cfg = RenderConfig()
    n = 8192
    state = _round_state(n, 30, kernel != "bounce12")
    name = bounce.build_name(kernel, key_mode, ordered)
    for bcap in (1, 3):
        launches.reset()
        if kernel == "bounce_packed":
            sf = torch.cat([state[0:12].view(torch.float32),
                            (state[-3] != 0).to(torch.float32)[None]])
            si = state[[-4, -1]].contiguous()
            got = bounce.bounce_packed(scene, sf, si, bcap, True, cfg,
                                       key_mode)
            want = bounce.bounce_packed_plain(scene, sf, si, bcap, True,
                                              cfg, key_mode)
        else:
            run = getattr(bounce, kernel)
            got = run(scene, state, bcap, True, cfg, key_mode, ordered)
            want = getattr(bounce, f"{kernel}_plain")(
                scene, state, bcap, True, cfg, key_mode, ordered)
        assert dict(launches.kernel) == {name: 1}
        for k, p in zip(got, want):
            assert torch.equal(k.view(torch.int32) if k.is_floating_point()
                               else k, p.view(torch.int32)
                               if p.is_floating_point() else p), (build, bcap)
        key = got[-2]
        assert len(torch.unique(key)) > 100


# Knobs of the sorted rounds -> the kernels a 256x192 frame launches
# (besides the ray-gen, the bounce-0 shade, the entry keys and the
# tonemap).
KNOB_FRAMES = {
    "SORT_KEY=pd5": ({"RAYTPU_SORT_KEY": "pd5"}, {"trace4", "bounce12_pd5"}),
    "SORT_KEY=om9,WAVE=fused": ({"RAYTPU_SORT_KEY": "om9",
                                 "RAYTPU_WAVE": "fused"},
                                {"trace4", "bounce15_om9"}),
    "SORT_KEY=pd5,WAVE=fused_packed": (
        {"RAYTPU_SORT_KEY": "pd5", "RAYTPU_WAVE": "fused_packed"},
        {"trace4", "bounce_packed_pd5", "bounce15_pd5"}),
    "ORDER_MINW": ({"RAYTPU_ORDER_MINW": str(1 << 30)},
                   {"trace4", "bounce12_unordered"}),
    "WAVE_BCAP=2,TAIL_BCAP=3": ({"RAYTPU_WAVE_BCAP": "2",
                                 "RAYTPU_TAIL_BCAP": "3"},
                                {"trace4", "bounce12"}),
    "GLUE=perfield,WAVE=fused,DEPOSIT=rows": (
        {"RAYTPU_GLUE": "perfield", "RAYTPU_WAVE": "fused",
         "RAYTPU_DEPOSIT": "rows"}, {"trace4", "bounce15"}),
    "PACK_GATHER=row,WAVE=fused_packed": (
        {"RAYTPU_PACK_GATHER": "row", "RAYTPU_WAVE": "fused_packed"},
        {"trace4", "bounce_packed", "bounce15"}),
    "DEEP_SUB=32,TAIL_MERGE=0": ({"RAYTPU_DEEP_SUB": "32",
                                  "RAYTPU_TAIL_MERGE": "0"},
                                 {"trace4", "bounce12"}),
}


@pytest.mark.parametrize("knob", list(KNOB_FRAMES))
def test_knob_frame_matches_plain(scene, monkeypatch, knob):
    """A 256x192 frame (three bands, the tail merge live) under each knob
    through the kernels and through the plain versions: 0 differing
    pixels, and the same bytes as the default frame through the kernels
    (each ray's path is its own), except that the unordered walk may pick
    another winner of an equal-t tie (at most 0.5% of the pixels)."""
    from raytracer_tpu_torch.core.camera import default_camera
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.engine.renderer import Renderer
    from raytracer_tpu_torch.kernels import launches

    cfg = RenderConfig(width=256, height=192, band_rays=16384)
    uni = default_camera(cfg.width, cfg.height).uniforms()
    acc_d, _, _ = Renderer(cfg).render(scene, uni)
    env, kernels = KNOB_FRAMES[knob]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    launches.reset()
    acc_k, img_k, st_k = Renderer(cfg).render(scene, uni)
    booked = kernels | {"raygen", "shade", "sort_key", "tonemap"}
    assert set(launches.kernel) == booked
    assert not launches.plain
    launches.reset()
    with launches.plain_versions():
        acc_p, img_p, st_p = Renderer(cfg).render(scene, uni)
    assert not launches.kernel and set(launches.plain) == booked
    assert torch.equal(acc_k.view(torch.int32), acc_p.view(torch.int32))
    assert torch.equal(img_k, img_p)
    assert int(st_k["rays_traced"]) == int(st_p["rays_traced"])
    if knob == "ORDER_MINW":
        differ = int((acc_k != acc_d).any(-1).sum())
        assert differ <= 0.005 * cfg.width * cfg.height
    else:
        assert torch.equal(acc_k.view(torch.int32),
                           acc_d.view(torch.int32))



# The table layouts off the default -> the knobs a scene is built under.
LAYOUTS = {"c2": {"RAYTPU_CLUSTER": "2"}, "c4": {"RAYTPU_CLUSTER": "4"},
           "w16": {"RAYTPU_WIDE": "16"},
           "c2w16": {"RAYTPU_CLUSTER": "2", "RAYTPU_WIDE": "16"},
           "c4w16": {"RAYTPU_CLUSTER": "4", "RAYTPU_WIDE": "16"}}
# Every build of kernel B: (wrapper, key, ordered).
ALL_BUILDS = [(k, key, True) for k in ("bounce12", "bounce15",
                                        "bounce_packed")
              for key in ("cid", "pd5", "om9")] + [
    (k, key, False) for k in ("bounce12", "bounce15")
    for key in ("cid", "pd5", "om9")]


@pytest.fixture(scope="module")
def layout_scenes(scene):
    """The ``scene`` fixture's terrain built under each layout's knobs."""
    from raytracer_tpu_torch.scene.builder import \
        build_fast_scene_from_arrays
    from raytracer_tpu_torch.utils import assets

    verts = assets.make_terrain(n=48, extent=30.0)
    r = np.random.default_rng(5)
    mats = np.zeros((verts.shape[0], 4), np.float32)
    mats[:, 0:3] = r.uniform(0.2, 0.9, (verts.shape[0], 3))
    mats[:, 3] = r.integers(0, 4, verts.shape[0])
    out = {}
    for name, env in LAYOUTS.items():
        with pytest.MonkeyPatch.context() as mp:
            for k, v in env.items():
                mp.setenv(k, v)
            out[name] = build_fast_scene_from_arrays(verts, mats,
                                                     device="cuda")
    return out


def _equal(got, want) -> bool:
    as_i = lambda t: t.view(torch.int32) if t.is_floating_point() else t
    return all(torch.equal(as_i(k), as_i(p)) for k, p in zip(got, want))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layout_kernels_match_plain(layout_scenes, layout):
    """Every kernel of a layout's library against its plain version on a
    scene of that layout: kernel A, both binary walks and ``mega`` (the
    cluster size only: their library is the 8-wide one of the same
    leaves), and all 15 builds of kernel B at bcap 1 and 3: 0 differing
    bytes, each launch booked under the layout's name."""
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.kernels import bounce, cuda_build, launches
    from raytracer_tpu_torch.kernels.mega import mega, mega_plain
    from raytracer_tpu_torch.kernels.trace import (trace2, trace2_plain,
                                                   trace4, trace4_plain)

    scene = layout_scenes[layout]
    assert cuda_build.layout_tag(scene.layout) == f"_{layout}"
    leaf_tag = cuda_build.layout_tag(cuda_build.leaf_layout(scene.layout))
    cfg = RenderConfig()
    o, d = _rays(8192, 11)
    rays = torch.cat([o, d]).contiguous()
    active = torch.arange(8192, device="cuda") % 7 != 0
    launches.reset()
    got = trace4(scene, rays, active, cfg)
    assert torch.equal(got, trace4_plain(scene, rays, active, cfg))
    assert (got[0] < cfg.t_max).float().mean() > 0.2
    for coherent in (False, True):
        got = trace2(scene, rays, active, cfg, coherent)
        assert torch.equal(got, trace2_plain(scene, rays, active, cfg))
    st = _mega_state(4097, 12, False)
    got = mega(scene, *st[:6], True, cfg, 0, st[6])
    want = mega_plain(scene, *st[:6], True, cfg, 0, st[6])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert dict(launches.kernel) == {
        f"trace4_{layout}": 1, f"trace2{leaf_tag}": 1,
        f"trace2_warp{leaf_tag}": 1, f"mega{leaf_tag}": 1}
    for kernel, key_mode, ordered in ALL_BUILDS:
        state = _round_state(8192, 30, kernel != "bounce12")
        name = bounce.build_name(kernel, key_mode, ordered, scene.layout)
        for bcap in (1, 3):
            launches.reset()
            if kernel == "bounce_packed":
                sf = torch.cat([state[0:12].view(torch.float32),
                                (state[-3] != 0).to(torch.float32)[None]])
                si = state[[-4, -1]].contiguous()
                got = bounce.bounce_packed(scene, sf, si, bcap, True, cfg,
                                           key_mode)
                want = bounce.bounce_packed_plain(scene, sf, si, bcap, True,
                                                  cfg, key_mode)
            else:
                got = getattr(bounce, kernel)(scene, state, bcap, True, cfg,
                                              key_mode, ordered)
                want = getattr(bounce, f"{kernel}_plain")(
                    scene, state, bcap, True, cfg, key_mode, ordered)
            assert dict(launches.kernel) == {name: 1}
            assert _equal(got, want), (name, bcap)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layout_frame_matches_plain(layout_scenes, layout):
    """A 256x192 frame (three bands, the tail merge live) of a layout's
    scene through its kernels and through the plain versions: 0
    differing bytes."""
    from raytracer_tpu_torch.core.camera import default_camera
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.engine.renderer import Renderer
    from raytracer_tpu_torch.kernels import launches

    scene = layout_scenes[layout]
    cfg = RenderConfig(width=256, height=192, band_rays=16384)
    uni = default_camera(cfg.width, cfg.height).uniforms()
    launches.reset()
    acc_k, img_k, _ = Renderer(cfg).render(scene, uni)
    booked = {"raygen", f"trace4_{layout}", "shade", "sort_key",
              f"bounce12_{layout}", "tonemap"}
    assert set(launches.kernel) == booked
    assert not launches.plain
    launches.reset()
    with launches.plain_versions():
        acc_p, img_p, _ = Renderer(cfg).render(scene, uni)
    assert not launches.kernel and set(launches.plain) == booked
    assert torch.equal(acc_k.view(torch.int32), acc_p.view(torch.int32))
    assert torch.equal(img_k, img_p)


def test_walk_kernels_at_the_16_wide_stack_limit(scene):
    """The 16-wide tree whose walk needs all 256 stack slots (it pushes
    241): kernels A and B of the width-16 library stay bit-equal to their
    plain versions and find the 8-wide tree's hits."""
    from raytracer_tpu_torch.bvh.bvh4 import nodes4_stack_need
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.kernels import cuda_build
    from raytracer_tpu_torch.kernels.bounce import (bounce12,
                                                    bounce12_plain,
                                                    pack_state)
    from raytracer_tpu_torch.kernels.trace import trace4, trace4_plain
    from raytracer_tpu_torch.scene import presets

    n = 4096
    deep, rays = presets.stack_limit_scene(n, device="cuda", width=16)
    assert nodes4_stack_need(deep.nodes4.cpu().numpy(), 16) == 256
    for name in ("trace4", "bounce12"):
        assert cuda_build.kernel_attrs(name, (8, 16))["local_bytes"] >= \
            4 * 256
    cfg = RenderConfig()
    active = torch.arange(n, device="cuda") % 5 != 0
    got = trace4(deep, rays, active, cfg)
    assert torch.equal(got, trace4_plain(deep, rays, active, cfg))
    deep8, _ = presets.stack_limit_scene(n, device="cuda")
    assert torch.equal(got, trace4(deep8, rays, active, cfg))
    g = torch.Generator(device="cuda").manual_seed(21)
    seed = torch.randint(0, 2 ** 32, (n,), generator=g, device="cuda")
    state = pack_state(tuple(rays[0:3]), tuple(rays[3:6]),
                       (torch.ones(n, device="cuda"),) * 3, seed, active, 3,
                       torch.arange(n, device="cuda"))
    for bcap in (1, 2):
        assert _equal(bounce12(deep, state, bcap, True, cfg),
                      bounce12_plain(deep, state, bcap, True, cfg))


# The ray-gen and shade kernels (csrc/front.cu) against their plain
# versions: 0 differing bytes in every output row, pad lanes included.
FC_BIG = 2 ** 20 + 7
# Band -> (config over RenderConfig(), band rows, band, frame counter,
# sample index): the flagship's three 240-row bands, c12's unjittered
# 640x480 band, and bands with a pad tail in tile-major (8x128 tiles) and
# raster order (no tile divides 120x200).
RAYGEN_BANDS = {
    **{f"flagship_band{b}_fc{fc}": ({}, 240, b, fc, 0)
       for b in range(3) for fc in (0, FC_BIG)},
    "c12": (dict(width=640, height=480, max_bounces=1,
                 shading="fixed_light"), 480, 0, 3, 0),
    "pad_tiles": (dict(width=128, height=80), 40, 1, FC_BIG, 0),
    "pad_tiles_reference": (dict(width=128, height=80,
                                 rng_mode="reference"), 40, 1, 5, 0),
    "pad_tiles_spp2": (dict(width=128, height=80, samples_per_pixel=2),
                       40, 1, 7, 1),
    "pad_raster": (dict(width=200, height=120), 120, 0, 9, 0),
    "pad_raster_c12": (dict(width=200, height=120, max_bounces=1,
                            shading="fixed_light"), 120, 0, 9, 0),
}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc)")


@pytest.fixture(scope="module")
def flagship(card):
    from raytracer_tpu_torch.scene import presets

    return presets.flagship_scene()


@pytest.fixture(scope="module")
def materials_scene(card):
    """The ``sphere_light`` preset (matte ground, metal sphere, emissive
    light) with every other metal triangle made fuzzy metal."""
    from raytracer_tpu_torch.scene import presets
    from raytracer_tpu_torch.scene.builder import (
        build_fast_scene_from_arrays, gather_triangles)

    p = presets.config2_sphere_light()
    verts, mats = gather_triangles(p.scene.create_snapshot())
    metal = np.flatnonzero(mats[:, 3] == 1.0)
    mats[metal[::2], 3] = 2.0
    assert set(np.unique(mats[:, 3])) == {0.0, 1.0, 2.0, 3.0}
    return build_fast_scene_from_arrays(verts, mats, device="cuda"), p


def _raygen_args(cfg, band_h, band, fc, sample_index, camera=None):
    """``primary_rays``' arguments for band ``band`` of cfg's frame."""
    import dataclasses

    from raytracer_tpu_torch.core.camera import default_camera
    from raytracer_tpu_torch.kernels.trace import BBLOCK, BLOCK

    cam = camera or default_camera(cfg.width, cfg.height)
    cam.frame_count = fc
    grain = max(BLOCK, BBLOCK)
    p_pad = -(-band_h * cfg.width // grain) * grain
    return (cam.uniforms(), dataclasses.replace(cfg, height=band_h), p_pad,
            band * band_h, cfg.height, sample_index, "cuda")


def _differing_bytes(got, want) -> int:
    """Bytes that differ between two (nested) tuples of tensors."""
    n = 0
    for g, w in zip(got, want, strict=True):
        if isinstance(g, tuple):
            n += _differing_bytes(g, w)
        elif g is None or w is None:
            assert g is None and w is None
        else:
            assert g.dtype == w.dtype and g.shape == w.shape
            n += int((g.contiguous().view(torch.uint8)
                      != w.contiguous().view(torch.uint8)).sum())
    return n


@pytest.mark.parametrize("band", list(RAYGEN_BANDS))
def test_raygen_kernel_matches_plain(card, band):
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.kernels import launches
    from raytracer_tpu_torch.kernels.packet import (primary_rays,
                                                    primary_rays_plain)

    over, band_h, b, fc, si = RAYGEN_BANDS[band]
    args = _raygen_args(RenderConfig(**over), band_h, b, fc, si)
    launches.reset()
    got = primary_rays(*args)
    assert dict(launches.kernel) == {"raygen": 1} and not launches.plain
    want = primary_rays_plain(*args)
    assert (got[1] is None) == (over.get("shading") == "fixed_light")
    assert _differing_bytes(got, want) == 0
    p = band_h * args[1].width
    assert int(got[2].sum()) == p and got[2].shape[0] == args[2]


def _bounce0(scene, cfg, args, sky_on):
    """Bounce 0 of a band: ray-gen, the walk, then the shade's arguments
    (kernel A's record of the primaries, colour 0, atten 1)."""
    from raytracer_tpu_torch.kernels.packet import primary_rays
    from raytracer_tpu_torch.kernels.trace import traverse_rays

    rays, seed, alive, _ = primary_rays(*args)
    res = traverse_rays(scene, rays, alive, args[1], coherent=True)
    zero = torch.zeros(args[2], device="cuda")
    one = torch.ones(args[2], device="cuda")
    return (res, rays[0:3].unbind(0), rays[3:6].unbind(0),
            (zero,) * 3, (one,) * 3, seed, alive, sky_on, args[1])


def _shade_both(sargs):
    from raytracer_tpu_torch.kernels import launches
    from raytracer_tpu_torch.kernels.tracer import shade, shade_plain

    launches.reset()
    got = shade(*sargs)
    assert dict(launches.kernel) == {"shade": 1} and not launches.plain
    return got, shade_plain(*sargs)


@pytest.mark.parametrize("band", [f"flagship_band{b}_fc{fc}"
                                  for b in range(3) for fc in (0, FC_BIG)])
def test_shade_kernel_matches_plain_at_bounce0(flagship, band):
    """The bounce-0 shade of each flagship band as the default path runs
    it (ray-gen, kernel A, shade)."""
    from raytracer_tpu_torch.core.types import RenderConfig

    over, band_h, b, fc, si = RAYGEN_BANDS[band]
    cfg = RenderConfig(**over)
    got, want = _shade_both(_bounce0(flagship, cfg, _raygen_args(
        cfg, band_h, b, fc, si), True))
    assert _differing_bytes(got, want) == 0


@pytest.mark.parametrize("sky_on", [True, False])
@pytest.mark.parametrize("emits", [True, False])
def test_shade_kernel_matches_plain_on_materials(materials_scene, sky_on,
                                                 emits):
    """Matte, metal, fuzzy-metal and emissive hits and sky misses at
    640x480: bounce 0, then bounce 1 on its output (the rays that did not
    scatter dead), sky and ``emissive_emits`` on and off."""
    import dataclasses

    from raytracer_tpu_torch.kernels.trace import traverse

    scene, preset = materials_scene
    cfg = dataclasses.replace(preset.config, emissive_emits=emits)
    sargs = _bounce0(scene, cfg, _raygen_args(cfg, cfg.height, 0, FC_BIG,
                                              0, preset.camera), sky_on)
    got, want = _shade_both(sargs)
    assert _differing_bytes(got, want) == 0
    o, d, c, a, seed, alive = got
    assert bool(alive.any()) and not bool(alive.all())
    res = traverse(scene, o, d, alive, cfg)
    got, want = _shade_both((res, o, d, c, a, seed, alive, sky_on, cfg))
    assert _differing_bytes(got, want) == 0
    hits = torch.cat([r.mat_type[r.hit & live] for r, live in (
        (sargs[0], sargs[6]), (res, alive))])
    assert set(torch.unique(hits).tolist()) == {0.0, 1.0, 2.0, 3.0}


def test_shade_kernel_matches_plain_on_a_round(scene):
    """Rays from everywhere, 20% dead, colours, atten and seeds of any
    value, the hit record given as strided views (a [P, 8] record's
    columns): the kernel's wrapper copies them, and every lane, dead ones
    included, matches."""
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.kernels.trace import trace4
    from raytracer_tpu_torch.kernels.tracer import TraversalResult

    n = 8191
    o, d = _rays(n, 40)
    g = torch.Generator(device="cuda").manual_seed(41)
    alive = torch.rand(n, generator=g, device="cuda") < 0.8
    c = torch.rand((3, n), generator=g, device="cuda")
    a = torch.rand((3, n), generator=g, device="cuda")
    seed = torch.randint(0, 2 ** 32, (n,), generator=g, device="cuda")
    cfg = RenderConfig()
    rec = trace4(scene, torch.cat([o, d]).contiguous(), alive,
                 cfg).T.contiguous()
    res = TraversalResult(rec[:, 0], rec[:, 0] < cfg.t_max,
                          (rec[:, 1], rec[:, 2], rec[:, 3]),
                          (rec[:, 4], rec[:, 5], rec[:, 6]), rec[:, 7])
    for sky_on in (True, False):
        got, want = _shade_both((res, tuple(o), tuple(d), tuple(c),
                                 tuple(a), seed, alive, sky_on, cfg))
        assert _differing_bytes(got, want) == 0
        assert not bool((got[5] & ~alive).any())


def test_default_frame_front_matches_plain(scene):
    """Two 256x128 frames of the default path (two bands, the tail merge)
    with the ray-gen and the shade as kernels and as plain ops, every
    other kernel the same: accumulators, images and rays traced equal."""
    from raytracer_tpu_torch.core.camera import default_camera
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.engine.renderer import Renderer
    from raytracer_tpu_torch.kernels import launches

    cfg = RenderConfig(width=256, height=128, band_rays=16384)
    cam = default_camera(cfg.width, cfg.height)

    def frames():
        acc, out = None, []
        for fc in (0, 1):
            cam.frame_count = fc
            acc, img, st = Renderer(cfg).render(scene, cam.uniforms(), acc)
            out.append((acc.clone(), img, int(st["rays_traced"])))
        return out

    launches.reset()
    got = frames()
    assert dict(launches.kernel)["raygen"] == 4
    assert dict(launches.kernel)["shade"] == 4
    # Keys: each band's entry into the sorted rounds and the tail's.
    assert dict(launches.kernel)["sort_key"] == 6
    assert set(launches.kernel) == {"raygen", "trace4", "shade", "sort_key",
                                    "bounce12", "tonemap"}
    with launches.plain_versions("raygen", "shade"):
        launches.reset()
        want = frames()
    assert dict(launches.plain) == {"raygen": 4, "shade": 4}
    assert set(launches.kernel) == {"trace4", "sort_key", "bounce12",
                                    "tonemap"}
    for (ak, ik, rk), (ap, ip, rp) in zip(got, want):
        assert torch.equal(ak.view(torch.int32), ap.view(torch.int32))
        assert torch.equal(ik, ip) and rk == rp


# The sorted rounds' knob paths whose graphed frames are held to their
# eager ones (tests/test_torch_graph_ladder.py holds the same paths to
# JAX and to each other on the CPU).
GRAPH_PATHS = {
    "default": {},
    "fused": {"RAYTPU_WAVE": "fused"},
    "fused_packed": {"RAYTPU_WAVE": "fused_packed"},
    "sort_key_pos": {"RAYTPU_SORT_KEY": "pos"},
    "deposit_rows": {"RAYTPU_DEPOSIT": "rows"},
    "deposit_ch": {"RAYTPU_DEPOSIT": "ch"},
    "tail_merge_0": {"RAYTPU_TAIL_MERGE": "0"},
    "bcaps_unordered": {"RAYTPU_WAVE_BCAP": "2", "RAYTPU_TAIL_BCAP": "3",
                        "RAYTPU_ORDER_MINW": "65536"},
    "b0_pwave": {"RAYTPU_B0": "pwave"},
}


def _graph_frames(scene_of, cfg, poses):
    """A frame a camera of ``poses``, the accumulator carried, on the
    scene ``scene_of()`` -> [(accum, image, rays traced, the frame's
    ``launches.graphs`` counts)]."""
    from raytracer_tpu_torch.engine.renderer import Renderer
    from raytracer_tpu_torch.kernels import launches

    acc, out = None, []
    for fc, cam in enumerate(poses):
        cam.frame_count = fc
        before = dict(launches.graphs)
        acc, img, st = Renderer(cfg).render(scene_of(), cam.uniforms(), acc)
        ev = {k: v - before.get(k, 0) for k, v in launches.graphs.items()
              if v != before.get(k, 0)}
        out.append((acc.clone(), img.clone(), int(st["rays_traced"]), ev))
    return out


def _poses(cfg, n: int = 5):
    """The default pose, with frame 3 (the last of fewer) looking up into
    the sky: its rays die at bounce 0, so it runs fewer rounds than its
    neighbours."""
    from raytracer_tpu_torch.core.camera import Camera, default_camera

    poses = [default_camera(cfg.width, cfg.height) for _ in range(n)]
    poses[min(3, n - 1)] = Camera(
        origin=(0.0, 30.0, 0.0), look_at=(0.0, 60.0, 1.0), vfov_deg=20.0,
        aspect_ratio=cfg.width / cfg.height)
    return poses


def _is(kind, ev):
    return any(k.startswith(kind) for k in ev)


@pytest.mark.parametrize("path", list(GRAPH_PATHS))
def test_graphed_frames_equal_eager_frames(scene, monkeypatch, path):
    """Five 256x192 frames (three bands, the tail merge live) on one
    scene object, whose second render captures every step and whose later
    ones replay them, against five on fresh copies of it (each stays
    eager): 0 differing accumulator and image bytes, equal rays traced,
    in every frame, the capture frame and a frame of fewer rounds
    included."""
    import dataclasses

    from raytracer_tpu_torch.core.types import RenderConfig

    for k, v in GRAPH_PATHS[path].items():
        monkeypatch.setenv(k, v)
    cfg = RenderConfig(width=256, height=192, band_rays=16384)
    eager = _graph_frames(lambda: dataclasses.replace(scene), cfg,
                          _poses(cfg))
    one = dataclasses.replace(scene)
    got = _graph_frames(lambda: one, cfg, _poses(cfg))
    for f, (g, e) in enumerate(zip(got, eager)):
        assert torch.equal(g[0].view(torch.int32), e[0].view(torch.int32)), f
        assert torch.equal(g[1], e[1]) and g[2] == e[2], f
    assert not any(_is("capture", e[3]) or _is("replay", e[3])
                   for e in eager)
    assert not _is("capture", got[0][3]) and not _is("replay", got[0][3])
    assert _is("capture", got[1][3])
    for *_, ev in got[1:]:
        assert _is("replay", ev) and not _is("eager", ev), ev
    for *_, ev in got[2:]:
        assert not _is("capture", ev), ev
    rounds = [ev.get("replay.round", 0) for *_, ev in got[1:]]
    assert len(set(rounds)) > 1 and max(rounds) > 0, rounds


def test_scene_swap_replaces_the_graphs(scene):
    """A new scene object takes its device's workspace: the old one's
    graphs go, the new one renders eagerly first, captures at its second
    render, and its frames equal the eager ones."""
    import dataclasses

    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.kernels import stepgraphs

    cfg = RenderConfig(width=256, height=192, band_rays=16384)
    dev = torch.device(scene.device)
    a = dataclasses.replace(scene)
    _graph_frames(lambda: a, cfg, _poses(cfg, 3))
    old = stepgraphs._spaces[dev]
    assert old.scene is a and old.graphs
    b = dataclasses.replace(scene)
    got = _graph_frames(lambda: b, cfg, _poses(cfg, 3))
    new = stepgraphs._spaces[dev]
    assert new is not old and new.scene is b and new.graphs
    assert list(stepgraphs._spaces.values()) == [new]
    assert not _is("replay", got[0][3]) and _is("capture", got[1][3])
    assert _is("replay", got[2][3]) and not _is("capture", got[2][3])
    eager = _graph_frames(lambda: dataclasses.replace(scene), cfg,
                          _poses(cfg, 3))
    for g, e in zip(got, eager):
        assert torch.equal(g[0].view(torch.int32), e[0].view(torch.int32))


def test_engine_frame_with_a_rebuild_during_capture(tmp_path, monkeypatch):
    """``RenderEngine``'s render thread captures the steps at a scene's
    second render while the rebuild thread builds the next scene on the
    card (started and awaited inside the first capture): every frame the
    render thread made, the capture frame included, equals an eager
    render of its scene; the rebuilt scene then renders, captures and
    replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc)")
    import dataclasses
    import time

    from raytracer_tpu_torch.core.camera import Camera
    from raytracer_tpu_torch.core.types import RenderConfig
    from raytracer_tpu_torch.engine.loop import RenderEngine
    from raytracer_tpu_torch.engine.renderer import Renderer
    from raytracer_tpu_torch.kernels import launches, stepgraphs
    from raytracer_tpu_torch.scene.scene import ModelInstance, Scene
    from raytracer_tpu_torch.utils import assets

    path = str(tmp_path / "cube.obj")
    assets.write_obj(path, assets.make_cube() * 5.0)
    plane = str(tmp_path / "plane.obj")
    assets.write_obj(plane, assets.make_ground_plane())
    first = Scene([ModelInstance(path),
                   ModelInstance(plane, position=(0.0, -5.0, 0.0),
                                 scale=(60.0, 1.0, 60.0))])
    second = Scene([ModelInstance(path, position=(3.0, 0.0, 0.0)),
                    ModelInstance(plane, position=(0.0, -5.0, 0.0),
                                  scale=(60.0, 1.0, 60.0))])
    cfg = RenderConfig(width=256, height=128, band_rays=16384)
    engine = RenderEngine(cfg, device="cuda", ladder_frames=0)
    made, rebuilt = [], []
    render = engine.renderer.render

    def recording(scene, cam, accum=None):
        out = render(scene, cam, accum)
        made.append((scene, out[1].clone()))
        return out

    record = stepgraphs.Workspace._record

    def record_with_rebuild(self, fn):
        def step():
            fn()
            if not rebuilt:
                rebuilt.append(engine.rebuild_scene_async(second).result(
                    timeout=120))
        return record(self, step)

    monkeypatch.setattr(engine.renderer, "render", recording)
    monkeypatch.setattr(stepgraphs.Workspace, "_record", record_with_rebuild)
    launches.reset()
    engine.start()
    try:
        a = engine.rebuild_scene_async(first).result(timeout=120)
        cam = Camera(origin=(0.0, 4.0, 30.0), look_at=(0.0, 0.0, 0.0),
                     vfov_deg=40.0, aspect_ratio=2.0)
        engine.submit_camera_update(cam.uniforms())
        deadline = time.time() + 120
        while time.time() < deadline and (
                not rebuilt or sum(s is rebuilt[0] for s, _ in made) < 4):
            time.sleep(0.01)
    finally:
        engine.stop()
    assert rebuilt, "the rebuild never ran inside a capture"
    b = rebuilt[0]
    assert sum(s is a for s, _ in made) >= 2
    assert sum(s is b for s, _ in made) >= 4
    assert launches.graphs["replay.round"] > 0
    monkeypatch.setattr(stepgraphs.Workspace, "_record", record)
    want = {id(s): Renderer(cfg).render(dataclasses.replace(s),
                                        cam.uniforms())[1]
            for s in (a, b)}
    for s, image in made:
        assert torch.equal(image, want[id(s)])
