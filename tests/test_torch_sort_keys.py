"""The sort keys of ``RAYTPU_SORT_KEY`` and kernel B's ``pd5`` and ``om9``
builds against the JAX package, from one JAX child process.

* ``test_host_sort_key_matches_jax``: ``keys.sort_key`` in its five modes
  (``pd5``, ``om9``, ``cid``, ``pos``, ``oct_morton``) and an unknown one
  at dead bits 30 and 31 against ``wavefront.sort_key`` (XLA), bit for
  bit, on seeded rays with origins outside the root box and on its faces,
  directions with +-0 components, dead rays, and a few +-inf and NaN
  coordinates (XLA's conversion takes NaN to 0).
* ``test_kernel_b_build_matches_pallas``: the plain ``bounce12``,
  ``bounce15`` and ``bounce_packed`` builds of the ``pd5`` and ``om9``
  keys against ``bounce_megakernel12`` / ``bounce_megakernel`` /
  ``bounce_megakernel_packed`` in interpret mode on one 2048-ray tile at
  bcap 1: key, seed, budget, alive, origin, colour and atten bit-equal,
  the scattered direction within 2 ulp (XLA:CPU's normalisation,
  ROADMAP queue 3 item 3; 5 lanes of 2048 here), counts equal, on every
  lane whose walk is not an equal-t tie (``tie_lanes``; where the TPU's
  tile walk may pick another winner, and with it another origin and key).
* ``test_frame_matches_jax``: the 64x32 two-band frame of
  ``tests/test_torch_paths.py`` under ``RAYTPU_SORT_KEY=pd5`` through the
  port's ``Renderer`` and the JAX one, with that file's tolerance.

The six Pallas lowerings (~20 s each) and the frame's run in three JAX
children at once (``run_children``): the host keys, the pd5
``bounce_megakernel12`` and the frame, whose kernel B call reuses that
lowering; two more builds; the last two.

The key kernel (``keys.sort_key`` on the card, ``csrc/front.cu``), with no
JAX child: ``test_key_kernel_matches_plain`` (marked ``cuda``, skipped
without a card) holds it to ``sort_key_plain`` in every mode at both dead
bits, 0 differing keys, on rows with NaN and +-inf coordinates, origins
outside the box, dead rays, a width off its 256-thread blocks, in a box
with a zero-width axis, as contiguous rows and as strided views. On the
CPU the wrapper runs and books the plain version, kernel B's plain
version keys without the wrapper, and a frame books one key at each
entry of the sorted rounds (and one a round on the split engine). On the
card:

    python -m pytest --noconftest tests/test_torch_sort_keys.py -q \
        -k kernel_matches_plain
"""

import numpy as np
import pytest
import torch

from test_torch_paths import CAM, CFG
from test_torch_renderer import _bounce0_tie_pixels, _sub, _two_cubes
from test_torch_trace2 import scene_arrays
from torch_jax_refs import run_children, tie_lanes

from raytracer_tpu_torch.core.camera import Camera
from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.engine.renderer import Renderer, _num_bands
from raytracer_tpu_torch.kernels import launches, wavefront
from raytracer_tpu_torch.kernels.bounce import (ROW_ALIVE, ROW_BUDGET,
                                                ROW_SEED, bounce12, bounce15,
                                                bounce_packed, build_name,
                                                pack_state)
from raytracer_tpu_torch.kernels.keys import sort_key, sort_key_plain
from raytracer_tpu_torch.kernels.packet import (tail_merge_active,
                                                tail_merge_widths)
from raytracer_tpu_torch.scene.builder import (build_fast_scene_from_arrays,
                                               camera_uniforms_from_numpy,
                                               fast_scene_from_numpy)

torch.set_num_threads(2)

W = 2048
MODES = ("pd5", "om9", "cid", "pos", "oct_morton", "zorder")
BUILDS = [f"{k}:{m}:1" for k in ("b12", "b15", "packed")
          for m in ("pd5", "om9")]


def _key_inputs(r, bounds):
    lo, hi = bounds[0:3], bounds[3:6]
    span = hi - lo
    o = r.uniform(lo - 0.2 * span, hi + 0.2 * span, (W, 3)).astype(
        np.float32)
    o[:8], o[8:16] = lo, hi
    d = r.standard_normal((W, 3)).astype(np.float32)
    d[:W // 4, 0] = 0.0
    d[W // 4:W // 2, 1] = -0.0
    o[16], o[17], o[18] = np.inf, -np.inf, np.nan
    d[19], d[20] = np.inf, np.nan
    return o.T.copy(), d.T.copy(), r.random(W) < 0.7


def _state_inputs(scene):
    r = np.random.default_rng(1010)
    n8 = scene.nodes8.numpy()
    lo, hi = n8[0, 0:3], n8[0, 3:6]
    o = r.uniform(lo, hi, (W, 3)).astype(np.float32)
    d = r.standard_normal((W, 3)).astype(np.float32)
    d[:W // 8, 1] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    c = r.uniform(0.0, 0.3, (W, 3)).astype(np.float32)
    a = r.uniform(0.0, 1.0, (W, 3)).astype(np.float32)
    act = (r.random(W) < 0.8).astype(np.float32)
    seed = r.integers(0, 2 ** 32, W, dtype=np.uint64).astype(np.uint32)
    budget = np.full(W, 1 << 30, np.int32)
    f = np.concatenate([o.T, d.T, c.T, a.T, act[None]]).astype(np.float32)
    i = np.stack([seed.view(np.int32), budget, np.arange(W, dtype=np.int32)])
    return f, i


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    verts, mats = scene_arrays()
    scene = build_fast_scene_from_arrays(verts, mats, device="cpu")
    bounds = scene.nodes8.numpy()[0, :6].copy()
    ko, kd, ka = _key_inputs(np.random.default_rng(31), bounds)
    f, i = _state_inputs(scene)
    fverts, fmats = _two_cubes()
    state = dict(verts=verts, mats=mats, f=f, i=i, sky=1, bcap=1)
    first, rest = BUILDS[0], BUILDS[1:]
    assert first == "b12:pd5:1"
    (keys, builds, frame), (b2,), (b3,) = run_children([
        ([("sort_keys", dict(key_o=ko, key_d=kd, key_alive=ka,
                             bounds=bounds, modes=np.array(MODES)), None),
          ("bounce_builds", dict(state, builds=np.array([first])), None),
          ("frames", dict(verts=fverts, mats=fmats, frames=1, **CAM,
                          **{f"cfg_{k}": v for k, v in CFG.items()}),
           {"RAYTPU_SORT_KEY": "pd5"})], None),
        ([("bounce_builds", dict(state, builds=np.array(rest[:3])), None)],
         None),
        ([("bounce_builds", dict(state, builds=np.array(rest[3:])), None)],
         None)], tmp_path_factory.mktemp("keys"))
    return dict(scene=scene, bounds=bounds, key_in=(ko, kd, ka), keys=keys,
                f=f, i=i, builds={**builds, **b2, **b3}, frame=frame)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dead_bit", [30, 31])
def test_host_sort_key_matches_jax(refs, mode, dead_bit):
    ko, kd, ka = refs["key_in"]
    b = torch.from_numpy(refs["bounds"])
    t = lambda a: tuple(torch.from_numpy(a[j]) for j in range(3))
    key = sort_key(t(ko), t(kd), torch.from_numpy(ka), b[0:3], b[3:6], mode,
                   dead_bit=dead_bit)
    got = key.numpy().astype(np.uint32).view(np.int32)
    np.testing.assert_array_equal(got, refs["keys"][f"key_{mode}_{dead_bit}"])
    # The inputs reach both clip ends and the +-0 octant bits.
    if mode == "pd5":
        assert (got & 1).any() and ((got >> 24) & 1).any()


def _port_state(f, i, color: bool):
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    return pack_state(tuple(t(f[j]) for j in range(3)),
                      tuple(t(f[j]) for j in range(3, 6)),
                      tuple(t(f[j]) for j in range(9, 12)),
                      t(i[0].view(np.uint32).astype(np.int64)),
                      t(f[12]) > 0.5, t(i[1]), t(i[2]),
                      color=tuple(t(f[j]) for j in range(6, 9)) if color
                      else None)


def run_build(scene, f, i, build, cfg, bcap=1):
    """The port's plain build "kernel:key_mode:ordered" (its wrapper on
    CPU tensors) on the job's state -> (floats as the JAX kernel returns
    them then alive, (seed, budget, key), counts)."""
    kernel, key_mode, ordered = build.split(":")
    if kernel == "packed":
        sf = torch.from_numpy(f).contiguous()
        si = torch.from_numpy(i[[0, 2]]).contiguous()
        sf_o, si_o, key, counts = bounce_packed(scene, sf, si, bcap, True,
                                                cfg, key_mode)
        got_i = np.stack([si_o[0].numpy(), np.full(W, 1 << 30, np.int32),
                          key.numpy()])
        return sf_o.numpy(), got_i, counts
    run = bounce15 if kernel == "b15" else bounce12
    out, key, counts = run(scene, _port_state(f, i, kernel == "b15"), bcap,
                           True, cfg, key_mode, bool(int(ordered)))
    nf = 12 if kernel == "b15" else 9
    got_f = np.concatenate([out[0:nf].view(torch.float32).numpy(),
                            (out[ROW_ALIVE] != 0).numpy()[None]
                            .astype(np.float32)])
    got_i = np.stack([out[ROW_SEED].numpy(), out[ROW_BUDGET].numpy(),
                      key.numpy()])
    return got_f, got_i, counts


@pytest.mark.parametrize("build", BUILDS)
def test_kernel_b_build_matches_pallas(refs, build):
    scene, f, i, ref = refs["scene"], refs["f"], refs["i"], refs["builds"]
    cfg = RenderConfig()
    launches.reset()
    got_f, got_i, counts = run_build(scene, f, i, build, cfg)
    kernel, key_mode, _ = build.split(":")
    base = {"b12": "bounce12", "b15": "bounce15"}.get(kernel,
                                                      "bounce_packed")
    assert dict(launches.plain) == {build_name(base, key_mode): 1}
    want_f, want_i = ref[f"{build}_f"], ref[f"{build}_i"]
    ulps = np.abs(got_f.view(np.int32).astype(np.int64)
                  - want_f.view(np.int32))
    ulps[3:6] = np.maximum(ulps[3:6] - 2, 0)
    differ = (ulps != 0).any(0) | (got_i != want_i).any(0)
    ties = tie_lanes(scene, [torch.from_numpy(f[j]) for j in range(3)],
                     [torch.from_numpy(f[j]) for j in range(3, 6)],
                     torch.from_numpy(f[12] > 0.5), cfg).numpy()
    assert not (differ & ~ties).any(), np.nonzero(differ & ~ties)[0][:10]
    assert differ.sum() < 0.01 * W
    if not differ.any():
        assert int(counts[0]) == ref[f"{build}_rays"]
        assert int(counts[1]) == ref[f"{build}_live"]
    # Real work and a real key: some rays scattered, some died, and the
    # live keys spread over many codes.
    assert 0 < int(counts[1]) < int(counts[0])
    live_keys = got_i[2][got_f[-1] > 0.5]
    assert (live_keys >> 30 == 0).all() and len(np.unique(live_keys)) > 100


def test_frame_matches_jax(refs, monkeypatch):
    ref = refs["frame"]
    scene = fast_scene_from_numpy(_sub(ref, "scene_"), device="cpu")
    uni = camera_uniforms_from_numpy(_sub(ref, "cam0_"), device="cpu")
    cfg = RenderConfig(**CFG)
    monkeypatch.setattr(wavefront, "MIN_WIDTH", 2048)
    monkeypatch.setenv("RAYTPU_SORT_KEY", "pd5")
    launches.reset()
    accum, image, stats = Renderer(cfg).render(scene, uni)
    assert set(launches.plain) == {"raygen", "trace4", "shade", "sort_key",
                                   "bounce12_pd5", "tonemap"}
    np.testing.assert_allclose(accum.numpy(), ref["accum_0"], rtol=0,
                               atol=2e-5)
    differ = (image.numpy() != ref["image_0"]).any(-1)
    ties = _bounce0_tie_pixels(scene, cfg, uni)
    assert not (differ & ~ties).any(), np.argwhere(differ & ~ties)[:10]
    assert int(stats["rays_traced"]) == int(ref["rays_0"])


# The key kernel's rays: _key_inputs' cases cut to a width off the
# kernel's 256-thread blocks, in the root box of scene_arrays' terrain.
KEY_W = W - 5
BOUNDS = np.array([-30.0, -8.042026, -30.0, 30.0, 12.0001, 30.0],
                  np.float32)


def _kernel_inputs(device, flat: bool = False, strided: bool = False):
    """(origin rows, direction rows, alive, smin, smax) on ``device``;
    ``flat``: the box's y axis has no width, and a tenth of the origins lie
    on its plane; ``strided``: the rows are views of one [n, 6] tensor."""
    bounds = BOUNDS.copy()
    if flat:
        bounds[4] = bounds[1]
    o, d, alive = _key_inputs(np.random.default_rng(77), bounds)
    o, d, alive = o[:, :KEY_W], d[:, :KEY_W], alive[:KEY_W]
    if flat:
        o[1, 100:100 + KEY_W // 10] = bounds[1]
    rays = torch.from_numpy(np.concatenate([o, d])).to(device)
    rays = rays.T.contiguous().T if strided else rays.contiguous()
    assert rays[0].stride(0) == (6 if strided else 1)
    b = torch.from_numpy(bounds).to(device)
    return (tuple(rays[0:3]), tuple(rays[3:6]),
            torch.from_numpy(alive).to(device), b[0:3], b[3:6])


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dead_bit", [30, 31])
@pytest.mark.parametrize("flat", [False, True])
def test_key_kernel_matches_plain(card, mode, dead_bit, flat):
    for strided in (False, True):
        args = _kernel_inputs(card, flat, strided)
        launches.reset()
        got = sort_key(*args, mode, dead_bit)
        assert dict(launches.kernel) == {"sort_key": 1}
        assert not launches.plain
        want = sort_key_plain(*args, mode, dead_bit)
        assert got.dtype == (torch.int32 if dead_bit == 30
                             else torch.int64)
        differ = got.to(torch.int64) != want
        assert not bool(differ.any()), (strided, differ.nonzero()[:10])
    # The inputs reach dead keys and many codes.
    assert bool((got >> dead_bit == 1).any())
    assert len(torch.unique(got)) > 100


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dead_bit", [30, 31])
def test_key_wrapper_runs_the_plain_version(mode, dead_bit):
    args = _kernel_inputs("cpu", flat=True, strided=True)
    launches.reset()
    got = sort_key(*args, mode, dead_bit)
    assert dict(launches.plain) == {"sort_key": 1} and not launches.kernel
    assert got.dtype == (torch.int32 if dead_bit == 30 else torch.int64)
    assert torch.equal(got.to(torch.int64),
                       sort_key_plain(*args, mode, dead_bit))


def test_key_wrapper_refuses_other_dead_bits():
    args = _kernel_inputs("cpu")
    for dead_bit in (29, 32):
        with pytest.raises(ValueError, match="dead bit"):
            sort_key(*args, "cid", dead_bit)


@pytest.mark.parametrize("key_mode", ["pd5", "om9"])
def test_kernel_b_plain_keys_without_the_wrapper(key_mode):
    """Kernel B's plain version (``bounce12`` on CPU tensors:
    ``bounce._rounds_plain``) emits its ``pd5`` / ``om9`` key with
    ``sort_key_plain``, not the ``sort_key`` wrapper: the plain build alone
    is booked, and its key is ``sort_key_plain`` of the state it returns at
    dead bit 30."""
    verts, mats = scene_arrays()
    scene = build_fast_scene_from_arrays(verts, mats, device="cpu")
    f, i = _state_inputs(scene)
    launches.reset()
    out, key, _ = bounce12(scene, _port_state(f, i, False), 1, True,
                           RenderConfig(), key_mode)
    assert dict(launches.plain) == {build_name("bounce12", key_mode): 1}
    fl = out[0:9].view(torch.float32)
    want = sort_key_plain(tuple(fl[0:3]), tuple(fl[3:6]),
                          out[ROW_ALIVE] != 0, *scene.bounds(), key_mode,
                          dead_bit=30)
    assert key.dtype == torch.int32 and torch.equal(key.to(torch.int64),
                                                    want)


@pytest.mark.parametrize("wave", ["fused12", "split"])
def test_frame_books_the_entry_keys(monkeypatch, wave):
    """A 256x96 frame of three bands: on the default engine one key at
    each band's entry into the sorted rounds and one at the merged tail's
    (kernel B carries every other key); on the split engine, which merges
    no tail, one at each band's entry and one after each round."""
    verts, mats = _two_cubes()
    scene = build_fast_scene_from_arrays(verts, mats, device="cpu")
    monkeypatch.setattr(wavefront, "MIN_WIDTH", 2048)
    monkeypatch.setenv("RAYTPU_WAVE", wave)
    cfg = RenderConfig(width=256, height=96, max_bounces=4, band_rays=8192)
    nb = _num_bands(cfg)
    assert nb == 3 and tail_merge_widths(cfg, cfg.height // nb, nb)
    merged = tail_merge_active(scene, cfg)
    assert merged == (wave == "fused12")
    rounds = []
    split_round = wavefront._Ladder._split_round
    monkeypatch.setattr(wavefront._Ladder, "_split_round",
                        lambda lad, st: rounds.append(1) or split_round(
                            lad, st))
    uni = Camera(origin=CAM["cam_origin"], look_at=CAM["cam_look"],
                 vfov_deg=CAM["cam_vfov"], aspect_ratio=8 / 3).uniforms(
        device="cpu")
    launches.reset()
    Renderer(cfg).render(scene, uni)
    assert launches.plain["sort_key"] == nb + (1 if merged else len(rounds))
    assert (len(rounds) > nb) == (wave == "split")
