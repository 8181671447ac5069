"""The port's multi-device renderer (``parallel/sharding.py``) on CPU ranks
over gloo.

One ``launch`` of four CPU ranks renders every mesh case, each on the
sub-mesh of the first dp * sp ranks: (dp, sp) = (2, 1), (1, 2), (2, 2) and
(4, 1) at 32x64 with spp = sp (``tests/test_parallel.py``'s
``test_sharded_matches_single_device``), (1, 2) and (2, 2) at spp 4
(several samples a slice), the cross-band tail merge at dp 2
(128x512, 4 bounces, 16384-ray bands: two merged bands a shard), the
per-ray path over a ``GpuScene`` and three accumulated frames. Each must
equal the single-device ``Renderer`` in this process: the u8 image
byte for byte, ``rays_traced`` exactly, and the accumulator byte for byte
where the case keeps it.

A JAX child (``jax_ref_jobs.job_mesh``, started while the ranks render)
runs the JAX ``MeshRenderer`` at (2, 1) on two virtual CPU devices, one
bounce (the Pallas interpret lowering of kernel B would double the
child's ~25 s; the bounces are held by the bit-equality above and by
``tests/test_torch_renderer.py``). The port's (2, 1) frames hold to it at
``tests/test_torch_renderer.py``'s tolerance (accumulator 2e-5, u8 equal
off bounce-0 tie pixels), on the same tables and uniforms (checked equal
first). A rank that raises fails the launch at once.
"""

import threading
import time

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.core.camera import Camera
from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.engine.renderer import Renderer, _num_bands
from raytracer_tpu_torch.kernels.packet import (_tile_major_pixels,
                                                tail_merge_widths)
from raytracer_tpu_torch.kernels.tracer import (initial_seed,
                                                make_primary_rays)
from raytracer_tpu_torch.parallel.sharding import (MeshRenderer, launch,
                                                   make_mesh, pick_backend)
from raytracer_tpu_torch.scene.builder import (build_fast_scene_from_arrays,
                                               build_gpu_scene_from_arrays)
from raytracer_tpu_torch.utils import assets
from torch_jax_refs import assert_scene_tables, run_job, tie_lanes

torch.set_num_threads(2)

W, H = 32, 64
MESHES = ((2, 1), (1, 2), (2, 2), (4, 1))
# spp past sp: each sp rank adds several samples before passing the sum on.
DEEP = ((1, 2, 4), (2, 2, 4))
TAIL = dict(width=128, height=512, max_bounces=4, band_rays=16384)
PER_RAY = dict(width=W, height=H, kernel="wavefront", max_bounces=3)
JAX = dict(width=W, height=H, max_bounces=1)
FRAMES = 3
CAM = dict(origin=(-10.0, 6.0, 30.0), look_at=(0.0, -6.0, 0.0),
           vfov_deg=40.0)
CPU4 = ["cpu"] * 4


def _arrays():
    """``tests/test_parallel.py``'s scene: a metal cube on a plane."""
    cube = assets.make_cube() * 4.0 + np.array([0, -6, 0], np.float32)
    plane = (assets.make_ground_plane() * np.array([150, 1, 150], np.float32)
             + np.array([0, -10, 0], np.float32))
    verts = np.concatenate([plane, cube]).astype(np.float32)
    mats = np.zeros((verts.shape[0], 4), np.float32)
    mats[:, 0:3] = (0.6, 0.5, 0.4)
    mats[2:, 3] = 1.0
    return verts, mats


def _cube():
    cube = assets.make_cube() * 4.0 + np.array([0, -6, 0], np.float32)
    mats = np.zeros((12, 4), np.float32)
    mats[:, 0:3] = 0.7
    return cube.astype(np.float32), mats


def _uniforms(cfg, fc: int = 0):
    cam = Camera(**CAM, aspect_ratio=cfg.width / cfg.height)
    cam.frame_count = fc
    return cam.uniforms(device="cpu")


def _frames(renderer, scene, cfg, n: int):
    """n progressive frames -> (accumulator, last image, last stats)."""
    accum = None
    for fc in range(n):
        accum, image, stats = renderer.render(scene, _uniforms(cfg, fc),
                                              accum)
    return accum, image, stats


def _rank(mesh):
    """Every case on its sub-mesh; rank 0's results (numpy)."""
    scene = build_fast_scene_from_arrays(*_arrays(), device="cpu")
    out = {}
    for dp, sp in MESHES:
        m = make_mesh(dp * sp, sp, CPU4)
        if m is None:
            continue
        cfg = RenderConfig(width=W, height=H, samples_per_pixel=sp)
        _, image, stats = MeshRenderer(cfg, m).render(scene, _uniforms(cfg))
        out[(dp, sp)] = (image.numpy(), int(stats["rays_traced"]))
    for dp, sp, spp in DEEP:
        m = make_mesh(dp * sp, sp, CPU4)
        if m is None:
            continue
        cfg = RenderConfig(width=W, height=H, samples_per_pixel=spp)
        r = MeshRenderer(cfg, m)
        accum, image, stats = r.render(scene, _uniforms(cfg))
        out[(dp, sp, spp)] = (image.numpy(), int(stats["rays_traced"]),
                              r.full_accumulator(accum).numpy())
    m = make_mesh(2, 1, CPU4)
    if m is not None:
        gscene = build_gpu_scene_from_arrays(*_cube(), device="cpu")
        for key, cfg, sc, n in (
                ("tail", RenderConfig(**TAIL), scene, 1),
                ("per_ray", RenderConfig(**PER_RAY), gscene, 1),
                ("frames", RenderConfig(width=W, height=H), scene, FRAMES),
                ("jax", RenderConfig(**JAX), scene, 2)):
            r = MeshRenderer(cfg, m)
            accum, image, stats = _frames(r, r.prepare_scene(sc), cfg, n)
            out[key] = (image.numpy(), int(stats["rays_traced"]),
                        r.full_accumulator(accum).numpy(), stats["samples"])
    return out if mesh.rank == 0 else None


def _single(scene, cfg, n: int = 1):
    accum, image, stats = _frames(Renderer(cfg), scene, cfg, n)
    return (image.numpy(), int(stats["rays_traced"]), accum.numpy(),
            stats["samples"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    verts, mats = _arrays()
    inp = dict(verts=verts, mats=mats, frames=2, dp=2, sp=1,
               cam_origin=np.array(CAM["origin"]),
               cam_look=np.array(CAM["look_at"]), cam_vfov=CAM["vfov_deg"],
               **{f"cfg_{k}": v for k, v in JAX.items()})
    ref, errors = {}, []
    flags = ("--xla_cpu_max_isa=AVX --xla_backend_optimization_level=0 "
             "--xla_force_host_platform_device_count=2")

    def jax_ref():
        try:
            ref.update(run_job("mesh", inp, tmp_path_factory.mktemp("mesh"),
                               env={"XLA_FLAGS": flags}))
        except Exception as e:  # raised again in the fixture's thread
            errors.append(e)

    child = threading.Thread(target=jax_ref)
    child.start()
    run = launch(_rank, 4, 1, devices=CPU4, timeout=600)
    scene = build_fast_scene_from_arrays(verts, mats, device="cpu")
    single = {(dp, sp): _single(scene, RenderConfig(
        width=W, height=H, samples_per_pixel=sp)) for dp, sp in MESHES}
    for spp in {spp for _, _, spp in DEEP}:
        single[spp] = _single(scene, RenderConfig(width=W, height=H,
                                                  samples_per_pixel=spp))
    single["tail"] = _single(scene, RenderConfig(**TAIL))
    single["per_ray"] = _single(build_gpu_scene_from_arrays(
        *_cube(), device="cpu"), RenderConfig(**PER_RAY))
    single["frames"] = _single(scene, RenderConfig(width=W, height=H),
                               FRAMES)
    child.join()
    if errors:
        raise errors[0]
    return run, single, ref, scene


def test_launch_runs_gloo_on_cpu_ranks(runs):
    run, _, _, _ = runs
    assert run.backend == "gloo"
    assert run.results[1:] == [None] * 3
    assert pick_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert pick_backend(["cuda:0", "cuda:0"]) == "gloo"


@pytest.mark.parametrize("dp,sp", MESHES, ids=[f"dp{d}_sp{s}"
                                               for d, s in MESHES])
def test_sharded_matches_single_device(runs, dp, sp):
    run, single, _, _ = runs
    image, rays = run.results[0][(dp, sp)]
    assert image.shape == (H, W, 3) and image.max() > 0
    assert image.tobytes() == single[(dp, sp)][0].tobytes()
    assert rays == single[(dp, sp)][1]


@pytest.mark.parametrize("dp,sp,spp", DEEP, ids=[f"dp{d}_sp{s}_spp{n}"
                                                  for d, s, n in DEEP])
def test_sharded_matches_single_device_past_spp_eq_sp(runs, dp, sp, spp):
    """Several samples a slice: the running sum passed along the sp ranks
    keeps the single-device order of additions, so the accumulator is
    byte for byte one device's (a sum of per-rank partial sums is not)."""
    run, single, _, _ = runs
    image, rays, accum = run.results[0][(dp, sp, spp)]
    assert image.max() > 0
    assert image.tobytes() == single[spp][0].tobytes()
    assert accum.tobytes() == single[spp][2].tobytes()
    assert rays == single[spp][1]


@pytest.mark.parametrize("case", ["tail", "per_ray", "frames"])
def test_sharded_case_matches_single_device(runs, case):
    """The tail merge (survivor pixel ids shifted to each shard's rows),
    the per-ray path and three accumulated frames: image, rays, the
    whole accumulator and the sample count equal."""
    run, single, _, _ = runs
    got, want = run.results[0][case], single[case]
    assert got[0].tobytes() == want[0].tobytes()
    assert got[1] == want[1]
    assert got[2].tobytes() == want[2].tobytes() and got[2].max() > 0
    assert got[3] == want[3]
    if case == "tail":
        cfg = RenderConfig(**{**TAIL, "height": TAIL["height"] // 2})
        nb = _num_bands(cfg)
        assert nb == 2 and tail_merge_widths(cfg, cfg.height // nb, nb)


def _bounce0_tie_pixels(scene, cfg, uni):
    """bool[H, W]: pixels whose primary ray's closest hit is an equal-t
    tie (``tests/test_torch_renderer.py``)."""
    nb = _num_bands(cfg)
    bh = cfg.height // nb
    ties = torch.zeros(cfg.height * cfg.width, dtype=torch.bool)
    for b in range(nb):
        xx, yy_local, alive = _tile_major_pixels(bh, cfg.width,
                                                 bh * cfg.width, "cpu")
        yy = yy_local + b * bh
        seed = initial_seed(uni, cfg, yy * cfg.width + xx, 0)
        _, o, d = make_primary_rays(uni, cfg, seed, xx, yy, cfg.height)
        ties[(yy * cfg.width + xx)[tie_lanes(scene, o, d, alive, cfg)]] = True
    return ties.reshape(cfg.height, cfg.width).numpy()


def test_mesh_matches_the_jax_mesh(runs):
    """(2, 1) against JAX's MeshRenderer, frame 1 of 2: same tables and
    uniforms, accumulator within 2e-5, u8 equal off tie pixels, rays
    equal."""
    run, _, ref, scene = runs
    assert_scene_tables(scene, ref, "scene_")
    cfg = RenderConfig(**JAX)
    for fc in range(2):
        uni = _uniforms(cfg, fc)
        for name in ("origin", "lower_left_corner", "horizontal",
                     "vertical"):
            assert getattr(uni, name).numpy().tobytes() == \
                ref[f"cam{fc}_{name}"].tobytes(), name
    image, rays, accum, samples = run.results[0]["jax"]
    np.testing.assert_allclose(accum, ref["accum_1"], rtol=0, atol=2e-5)
    differ = (image != ref["image_1"]).any(-1)
    ties = _bounce0_tie_pixels(scene, cfg, _uniforms(cfg, 0))
    assert not (differ & ~ties).any(), np.argwhere(differ & ~ties)[:10]
    assert rays == int(ref["rays_1"]) and samples == 2


def _fail_on_rank_1(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 gives up")
    torch.distributed.barrier()   # rank 0 waits for a peer that died
    return "unreachable"


def test_a_failing_rank_fails_the_launch():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        launch(_fail_on_rank_1, 2, devices=["cpu"] * 2, timeout=60)
    assert time.monotonic() - t0 < 60


def test_mesh_checks_its_config():
    with pytest.raises(ValueError, match="not divisible by sp"):
        launch(print, 3, sp=2, devices=["cpu"] * 3)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        launch(print, torch.cuda.device_count() + 1)
