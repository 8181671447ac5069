"""The colour-carrying kernel and the packed kernel, plain versions against
the JAX package.

References: ``bounce_megakernel`` (``make_kernel(carry_color=True)``) and
``bounce_megakernel_packed`` in interpret mode with ``key_mode="cid"`` and
2048-ray tiles, on 2048 rays of a ~800-triangle scene with colours, atten,
80% of rays alive and per-ray budgets 0..5 (rays entering alive at budget
0 and 1 included). ``bounce15_plain`` runs at bcap 1 and 3,
``bounce_packed_plain`` at bcap 1 with a pass-through si row. Seeds,
alive flags, budgets, pass-through rows and the rays/live counts must be
exact, floats within 2e-5, keys exact (at bcap 3 the cid bits of rays that
died in an earlier iteration are the TPU tile's re-zeroed ones, so only
their dead bit and octant are compared), on every lane that is not an
equal-t tie in one of its walks (where the TPU's tile walk may pick
another winner).
"""

import numpy as np
import pytest
import torch

from test_torch_trace2 import scene_arrays
from torch_jax_refs import run_job, tie_lanes

from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.kernels import launches
from raytracer_tpu_torch.kernels.bounce import (ROW_ALIVE, ROW_BUDGET,
                                                ROW_SEED, bounce15,
                                                bounce15_plain,
                                                bounce_packed,
                                                bounce_packed_plain,
                                                pack_state, unpack_floats)
from raytracer_tpu_torch.scene.builder import build_fast_scene_from_arrays

torch.set_num_threads(2)

W = 2048
BCAPS = (1, 3)


def _inputs(scene):
    r = np.random.default_rng(77)
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
    budget = r.integers(0, 6, W).astype(np.int32)
    f = np.concatenate([o.T, d.T, c.T, a.T, act[None]]).astype(np.float32)
    i = np.stack([seed.view(np.int32), budget, np.arange(W, dtype=np.int32)])
    return f, i


def _port_state(f, i):
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    return pack_state(tuple(t(f[j]) for j in range(3)),
                      tuple(t(f[j]) for j in range(3, 6)),
                      tuple(t(f[j]) for j in range(9, 12)),
                      t(i[0].view(np.uint32).astype(np.int64)),
                      t(f[12]) > 0.5, t(i[1]), t(i[2]),
                      color=tuple(t(f[j]) for j in range(6, 9)))


def _tie_lanes_per_walk(scene, state, bcap, cfg):
    """bool[W]: rays whose walk in one of the first bcap iterations is an
    equal-t tie."""
    ties = torch.zeros(W, dtype=torch.bool)
    for _ in range(bcap):
        o, d, _, _ = unpack_floats(state)
        ties |= tie_lanes(scene, o, d, state[ROW_ALIVE] != 0, cfg)
        state, _, _ = bounce15_plain(scene, state, 1, True, cfg)
    return ties


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    verts, mats = scene_arrays()
    scene = build_fast_scene_from_arrays(verts, mats, device="cpu")
    f, i = _inputs(scene)
    inp = dict(verts=verts, mats=mats, f=f, i=i, sky=1,
               bcaps=np.array(BCAPS))
    return scene, inp, run_job("bounce15", inp,
                               tmp_path_factory.mktemp("b15"))


@pytest.mark.parametrize("bcap", BCAPS)
def test_bounce15_plain_matches_pallas(case, bcap):
    scene, inp, ref = case
    cfg = RenderConfig()
    f, i = inp["f"], inp["i"]
    alive = f[12] > 0.5
    assert ((i[1] == 0) & alive).any() and ((i[1] == 1) & alive).any()
    state = _port_state(f, i)
    out, key, counts = bounce15_plain(scene, state, bcap, True, cfg)

    got_f = np.concatenate([out[0:12].view(torch.float32).numpy(),
                            (out[ROW_ALIVE] != 0).numpy()[None]
                            .astype(np.float32)])
    key = key.numpy()
    want_key = ref[f"b{bcap}_i"][2]
    live = out[ROW_ALIVE].numpy() != 0
    if bcap > 1:   # dead rays: dead bit and octant only
        mask = np.where(live, -1, (1 << 30) | 7).astype(np.int32)
        key, want_key = key & mask, want_key & mask
    got_i = np.stack([out[ROW_SEED].numpy(), out[ROW_BUDGET].numpy(), key])
    want_i = np.stack([ref[f"b{bcap}_i"][0], ref[f"b{bcap}_i"][1],
                       want_key])
    differ = ((np.abs(got_f - ref[f"b{bcap}_f"]) > 2e-5).any(0)
              | (got_i != want_i).any(0))
    ties = _tie_lanes_per_walk(scene, state, bcap, cfg).numpy()
    assert not (differ & ~ties).any(), np.nonzero(differ & ~ties)[0][:10]
    assert differ.sum() < 0.01 * W
    if not differ.any():
        assert int(counts[0]) == ref[f"b{bcap}_rays"]
        assert int(counts[1]) == ref[f"b{bcap}_live"]
    # The round did real work: some rays scattered, some died, and the
    # colour changed where rays missed.
    assert 0 < int(counts[1]) < int(counts[0])
    assert (got_f[6:9] != f[6:9]).any()


def test_bounce_packed_plain_matches_pallas(case):
    scene, inp, ref = case
    cfg = RenderConfig()
    sf = torch.from_numpy(inp["f"]).contiguous()
    si = torch.from_numpy(ref["packed_si_in"]).contiguous()
    sf_out, si_out, key, counts = bounce_packed_plain(scene, sf, si, 1,
                                                      True, cfg)
    differ = ((np.abs(sf_out.numpy() - ref["packed_sf"]) > 2e-5).any(0)
              | (si_out.numpy() != ref["packed_si"]).any(0)
              | (key.numpy() != ref["packed_key"]))
    ties = tie_lanes(scene, sf[0:3], sf[3:6], sf[12] > 0.5, cfg).numpy()
    assert not (differ & ~ties).any(), np.nonzero(differ & ~ties)[0][:10]
    assert torch.equal(si_out[1:], si[1:])
    if not differ.any():
        assert int(counts[0]) == ref["packed_rays"]
        assert int(counts[1]) == ref["packed_live"]
    assert set(np.unique(sf_out[12].numpy())) <= {0.0, 1.0}


def test_packed_and_flat_layouts_agree(case):
    """bounce_packed is bounce15 over another layout, with the budget
    fixed at 1 << 30."""
    scene, inp, _ = case
    cfg = RenderConfig()
    f, i = inp["f"], inp["i"]
    i = np.stack([i[0], np.full(W, 1 << 30, np.int32), i[2]])
    out, key, counts = bounce15_plain(scene, _port_state(f, i), 2, True, cfg)
    sf = torch.from_numpy(f).contiguous()
    si = torch.from_numpy(i[[0, 2]]).contiguous()
    sf_p, si_p, key_p, counts_p = bounce_packed_plain(scene, sf, si, 2, True,
                                                      cfg)
    assert torch.equal(sf_p[0:12].view(torch.int32), out[0:12])
    assert torch.equal(si_p[0], out[ROW_SEED])
    assert torch.equal(key_p, key) and torch.equal(counts_p, counts)


def test_wrappers_route_cpu_tensors_and_check_shapes(case):
    scene, inp, _ = case
    cfg = RenderConfig()
    state = _port_state(inp["f"], inp["i"])
    sf = torch.from_numpy(inp["f"]).contiguous()
    si = torch.from_numpy(inp["i"]).contiguous()
    launches.reset()
    out, key, _ = bounce15(scene, state, 1, True, cfg)
    bounce_packed(scene, sf, si, 1, True, cfg)
    assert dict(launches.plain) == {"bounce15": 1, "bounce_packed": 1}
    assert not launches.kernel and launches.work["draws"] > 0
    assert out.shape == state.shape and key.dtype == torch.int32
    with pytest.raises(ValueError):
        bounce15(scene, state[:13].contiguous(), 1, True, cfg)
    with pytest.raises(ValueError):
        bounce_packed(scene, sf[:12].contiguous(), si, 1, True, cfg)
