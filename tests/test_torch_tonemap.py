"""The tonemap's plain version against the JAX package.

References: the Pallas ``tonemap_accumulate`` (interpret mode) for the
accumulate + tonemap, and ``engine.renderer.tonemap`` for the plain-op
tonemap. The port's tonemap takes the renderer's planar band sum
f32[3, H*W] and the sample count; the JAX kernel gets the numpy transpose
of the same sum divided by spp. The frame holds values whose gamma * 255
is exactly 127.5, so the round-half-to-even rule is exercised. u8 images
and accumulators must be bit-equal.
"""

import numpy as np
import pytest
import torch

from torch_jax_refs import run_job

from raytracer_tpu_torch.engine.renderer import tonemap
from raytracer_tpu_torch.kernels import launches
from raytracer_tpu_torch.kernels.tonemap import (tonemap_accumulate,
                                                 tonemap_plain)

torch.set_num_threads(2)

H, W = 24, 40
FCS = (0, 3, 0, 1)
EXPOSURES = (0.0, 0.5, -1.0, 1.0)
# Planar cases: (spp, fc, exposure).
PLANAR = ((1, 0, 0.0), (2, 0, 0.0), (1, 4, 0.5), (2, 3, -1.0))


def _planar(sample):
    """f32[H, W, 3] -> the planar f32[3, H*W] layout of the band sum."""
    return np.ascontiguousarray(sample.reshape(H * W, 3).T)


def _totals(sample):
    """One band sum per planar case: the sample times spp, with row 1 at
    total / spp = 0.25, whose gamma * 255 is 127.5 at fc 0, exposure 0."""
    out = []
    for spp, _, _ in PLANAR:
        t = (sample * np.float32(spp)).astype(np.float32)
        t[1, :, :] = np.float32(0.25 * spp)
        out.append(_planar(t))
    return np.stack(out)


def _inputs():
    r = np.random.default_rng(7)
    accum = r.uniform(0.0, 1.5, (H, W, 3)).astype(np.float32)
    sample = r.uniform(0.0, 1.5, (H, W, 3)).astype(np.float32)
    sample[0, :, 0] = -0.25                       # clamps to black
    # With fc = 0 the new accumulator is the sample: 0.25 at exposure 0,
    # 0.5 at -1 and 0.125 at +1 all give gamma * 255 == 127.5 exactly.
    sample[1, :, :] = (0.25, 0.5, 0.125)
    linear = sample.copy()
    linear[2, :, :] = (0.25, 0.5, 0.125)
    totals = _totals(sample)
    # What the JAX kernel gets: the numpy transpose of each sum / spp.
    xsamples = np.stack([(tot.T / np.float32(spp)).reshape(H, W, 3)
                         for tot, (spp, _, _) in zip(totals, PLANAR)])
    return dict(accum=accum, sample=sample, linear=linear,
                fc=np.asarray(FCS, np.float32),
                exposure=np.asarray(EXPOSURES, np.float32),
                totals=totals, xsamples=xsamples.astype(np.float32),
                xfc=np.asarray([c[1] for c in PLANAR], np.float32),
                xexposure=np.asarray([c[2] for c in PLANAR], np.float32))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    inp = _inputs()
    return inp, run_job("tonemap", inp, tmp_path_factory.mktemp("tm"))


@pytest.mark.parametrize("j", range(len(FCS)))
def test_accumulate_tonemap_bit_equal(case, j):
    inp, ref = case
    acc, img = tonemap_plain(torch.from_numpy(inp["accum"].copy()),
                             torch.from_numpy(_planar(inp["sample"])), 1,
                             torch.tensor(FCS[j], dtype=torch.int32),
                             torch.tensor(EXPOSURES[j]))
    assert acc.numpy().tobytes() == ref[f"acc_{j}"].tobytes()
    np.testing.assert_array_equal(img.numpy(), ref[f"img_{j}"])
    if FCS[j] == 0:
        row = img.numpy()[1]
        assert (row == 128).any()   # 127.5 rounds half to even


@pytest.mark.parametrize("j", range(len(FCS)))
def test_plain_tonemap_bit_equal(case, j):
    inp, ref = case
    img = tonemap(torch.from_numpy(inp["linear"]), EXPOSURES[j])
    np.testing.assert_array_equal(img.numpy(), ref[f"plain_img_{j}"])


def test_wrapper_updates_in_place_on_cpu(case):
    inp, _ = case
    acc = torch.from_numpy(inp["accum"].copy())
    launches.reset()
    out, img = tonemap_accumulate(
        acc, torch.from_numpy(_planar(inp["sample"])), 1, 2, 0.0)
    assert out is acc and img.dtype == torch.uint8
    assert launches.plain["tonemap"] == 1 and not launches.kernel


@pytest.mark.parametrize("j", range(len(PLANAR)))
def test_planar_total_bit_equal(case, j):
    """The band sum at spp 1 and 2, fc 0 and > 0, against the JAX kernel
    on its numpy transpose / spp."""
    inp, ref = case
    spp, fc, ex = PLANAR[j]
    acc, img = tonemap_plain(torch.from_numpy(inp["accum"].copy()),
                             torch.from_numpy(inp["totals"][j]), spp,
                             torch.tensor(fc, dtype=torch.int32),
                             torch.tensor(ex))
    assert acc.numpy().tobytes() == ref[f"xacc_{j}"].tobytes()
    np.testing.assert_array_equal(img.numpy(), ref[f"ximg_{j}"])
    if fc == 0 and ex == 0.0:
        assert (img.numpy()[1] == 128).all()   # 127.5 rounds half to even


def test_plain_rejects_a_total_of_another_shape(case):
    inp, _ = case
    acc = torch.from_numpy(inp["accum"].copy())
    with pytest.raises(ValueError):
        tonemap_plain(acc, torch.from_numpy(inp["sample"]), 1, 0, 0.0)
