"""Kernel B's plain version and the round key against the JAX package.

The reference is ``bounce_megakernel12(..., interpret=True,
key_mode="cid", sub=16)`` at ``bcap=1``, the main path's setting, on 2048
rays: once with the uniform budget ``1 << 30`` and once with per-ray
budgets 0..2 (rays entering alive at budget 0 and 1 included). Seeds,
alive flags, budgets, keys and the rays/live counts must be exact, floats
within 2e-5 absolute, on every lane whose first walk is not an equal-t
tie (where the TPU's per-tile walk may pick another winner).
"""

import numpy as np
import pytest
import torch

from test_torch_trace import _scene_arrays
from torch_jax_refs import run_job, tie_lanes

from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.kernels import launches
from raytracer_tpu_torch.kernels.bounce import (ROW_ALIVE, ROW_BUDGET,
                                                ROW_SEED, bounce12,
                                                bounce12_plain, pack_state)
from raytracer_tpu_torch.kernels.wavefront import sort_key
from raytracer_tpu_torch.scene.builder import build_fast_scene_from_arrays

torch.set_num_threads(2)

W = 2048


def _state(r, scene, budget):
    n4 = scene.nodes4.numpy()[:1].reshape(8, 16)
    lo, hi = n4[:, 0:3].min(0), n4[:, 3:6].max(0)
    o = r.uniform(lo, hi, (W, 3)).astype(np.float32)
    d = r.standard_normal((W, 3)).astype(np.float32)
    d[:W // 8, 1] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    a = r.uniform(0.0, 1.0, (W, 3)).astype(np.float32)
    act = (r.random(W) < 0.8).astype(np.float32)
    seed = r.integers(0, 2 ** 32, W, dtype=np.uint64).astype(np.uint32)
    f = np.concatenate([o.T, d.T, a.T, act[None]]).astype(np.float32)
    i = np.stack([seed.view(np.int32), budget.astype(np.int32)])
    return f, i


def _keys_inputs(r, scene):
    n4 = scene.nodes4.numpy()[:1].reshape(8, 16)
    lo, hi = n4[:, 0:3].min(0) - 3, n4[:, 3:6].max(0) + 3
    o = r.uniform(lo, hi, (W, 3)).astype(np.float32)
    o[:8] = scene.nodes8.numpy()[0, 0:3]
    o[8:16] = scene.nodes8.numpy()[0, 3:6]
    d = r.standard_normal((W, 3)).astype(np.float32)
    d[:W // 4, 0] = 0.0
    return o.T.copy(), d.T.copy(), r.random(W) < 0.7


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    verts, mats = _scene_arrays()
    scene = build_fast_scene_from_arrays(verts, mats, device="cpu")
    r = np.random.default_rng(2024)
    uf, ui = _state(r, scene, np.full(W, 1 << 30))
    bf, bi = _state(r, scene, r.integers(0, 3, W))
    ko, kd, ka = _keys_inputs(r, scene)
    inp = dict(verts=verts, mats=mats, bcap=1, sky=1, uniform_f=uf,
               uniform_i=ui, budget_f=bf, budget_i=bi, key_o=ko, key_d=kd,
               key_alive=ka)
    return scene, inp, run_job("bounce", inp, tmp_path_factory.mktemp("b"))


def _port_state(f, i):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    seed = t(i[0].view(np.uint32).astype(np.int64))
    return pack_state(tuple(t(f[j]) for j in range(3)),
                      tuple(t(f[j]) for j in range(3, 6)),
                      tuple(t(f[j]) for j in range(6, 9)), seed,
                      t(f[9]) > 0.5, t(i[1]), torch.arange(W))


@pytest.mark.parametrize("name", ["uniform", "budget"])
def test_kernel_b_plain_matches_pallas(case, name):
    scene, inp, ref = case
    cfg = RenderConfig()
    f, i = inp[f"{name}_f"], inp[f"{name}_i"]
    state = _port_state(f, i)
    if name == "budget":
        alive = f[9] > 0.5
        assert ((i[1] == 0) & alive).any() and ((i[1] == 1) & alive).any()
    out, key, counts = bounce12_plain(scene, state, 1, True, cfg)

    got_f = np.concatenate([out[0:9].view(torch.float32).numpy(),
                            (out[ROW_ALIVE] != 0).numpy()[None]
                            .astype(np.float32)])
    got_i = np.stack([out[ROW_SEED].numpy(), out[ROW_BUDGET].numpy(),
                      key.numpy()])
    want_f, want_i = ref[f"{name}_f"], ref[f"{name}_i"]
    differ = (np.abs(got_f - want_f) > 2e-5).any(0) | (got_i != want_i).any(0)
    ties = tie_lanes(scene, [torch.from_numpy(f[j]) for j in range(3)],
                     [torch.from_numpy(f[j]) for j in range(3, 6)],
                     torch.from_numpy(f[9] > 0.5), cfg).numpy()
    assert not (differ & ~ties).any(), np.nonzero(differ & ~ties)[0][:10]
    assert differ.sum() < 0.01 * W
    if not differ.any():
        assert int(counts[0]) == ref[f"{name}_rays"]
        assert int(counts[1]) == ref[f"{name}_live"]
    # The round did real work: some rays scattered, some died.
    assert 0 < int(counts[1]) < int(counts[0])


@pytest.mark.parametrize("mode", ["cid", "om9"])
@pytest.mark.parametrize("dead_bit", [30, 31])
def test_sort_key_bit_equal(case, mode, dead_bit):
    scene, inp, ref = case
    smin, smax = scene.bounds()
    key = sort_key(tuple(torch.from_numpy(c) for c in inp["key_o"]),
                   tuple(torch.from_numpy(c) for c in inp["key_d"]),
                   torch.from_numpy(inp["key_alive"]), smin, smax,
                   dead_bit=dead_bit)
    got = key.numpy().astype(np.uint32).view(np.int32)
    np.testing.assert_array_equal(got, ref[f"key_{mode}_{dead_bit}"])


def test_bounce12_routes_cpu_tensors_to_plain(case):
    scene, inp, _ = case
    state = _port_state(inp["uniform_f"], inp["uniform_i"])
    launches.reset()
    out, key, counts = bounce12(scene, state, 1, True, RenderConfig())
    assert launches.plain["bounce12"] == 1 and not launches.kernel
    assert out.shape == state.shape and key.dtype == torch.int32
    with pytest.raises(ValueError):
        bounce12(scene, state[:12].contiguous(), 1, True, RenderConfig())
