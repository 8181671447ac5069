"""Whole runs of each cell on the CPU at a tiny size (the harness's look
for a card skipped, the program's plain versions underneath): a sound run
is correct, and a run whose timed path is broken is not. The faults a
frame of this program can have: a render step that returns its state
unchanged; half of the pixels left out (every other one black); an
answer altered where it is produced (every u8 value of the frame off by
four levels); a frame now and then gone wrong (every fourth frame's
radiance lost). The cells run on one card, so no exchange between cards
can be left out. The control (the reference in bfloat16 put in the
program's place) fails each cell's limits too."""

import json
import subprocess
import sys

import pytest
import torch

import numpy as np

import pbtest
from portbench import check, harness
from portbench.records import Call, Seen, Snap

CELLS = sorted(pbtest.TINY)


def _run(cell, seed=2_500_000_017, control=False):
    return harness.run_cell(cell, seed, pbtest.SECONDS[cell], False,
                            device="cpu", override=pbtest.TINY[cell],
                            log=lambda s: None, control=control)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_the_control_is_not(cell):
    r = _run(cell, control=True)
    assert r["correct"], r["check"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "check"
    names = {m["name"] for m in harness.metrics_for(
        harness.benchmark(), cell, False)}
    assert set(r["metrics"]) == names
    limits = harness.limits_of(cell)
    assert set(r["check"]) == set(limits)
    ok, _ = __import__("portbench.check", fromlist=["verdict"]).verdict(
        r["control"], limits)
    assert not ok, r["control"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_its_spans_and_window(cell):
    r = harness.run_cell(cell, 2_500_000_029, pbtest.SECONDS[cell], True,
                         device="cpu", override=pbtest.TINY[cell],
                         log=lambda s: None)
    assert r["correct"], r["check"]
    assert r["device"]["window_s"] > 0 and "breakdown" in r
    wanted = {m["name"] for m in harness.metrics_for(
        harness.benchmark(), cell, True)}
    # Off the card only the host spans can be read: device metrics and
    # the sync count stay out of the line.
    assert set(r["metrics"]) <= wanted
    assert not {"device.idle_share", "renderer.syncs_per_frame",
                "renderer.launches_per_frame"} & set(r["metrics"])
    if "wavefront.host_ms" in wanted:
        assert r["metrics"]["wavefront.host_ms"]["value"] > 0


def _state_unchanged(monkeypatch):
    from raytracer_tpu_torch.engine import renderer as rmod
    original = rmod.Renderer.render

    def render(self, scene, cam, accum=None):
        acc = accum if accum is not None else self.new_accumulator(
            scene.device)
        _, image, stats = original(self, scene, cam, acc.clone())
        return acc, torch.zeros_like(image), stats

    monkeypatch.setattr(rmod.Renderer, "render", render)


def _half_left_out(monkeypatch):
    from raytracer_tpu_torch.engine import renderer as rmod
    original = rmod._render_total

    def total(*a, **k):
        t, rays = original(*a, **k)
        t = t.clone()
        t[:, 1::2] = 0.0
        return t, rays

    monkeypatch.setattr(rmod, "_render_total", total)


def _answer_altered(monkeypatch):
    from raytracer_tpu_torch.engine import renderer as rmod
    original = rmod.Renderer.render

    def render(self, scene, cam, accum=None):
        acc, image, stats = original(self, scene, cam, accum)
        return acc, (image.to(torch.int16) + 4).clamp(0, 255).to(
            torch.uint8), stats

    monkeypatch.setattr(rmod.Renderer, "render", render)


def _some_frames_wrecked(monkeypatch):
    from raytracer_tpu_torch.engine import renderer as rmod
    original = rmod._render_total

    def total(scene, cam, *a, **k):
        t, rays = original(scene, cam, *a, **k)
        return (t * 0.0 if cam.fc_host % 4 == 3 else t), rays

    monkeypatch.setattr(rmod, "_render_total", total)


FAULTS = {"state_unchanged": _state_unchanged,
          "half_left_out": _half_left_out,
          "answer_altered": _answer_altered,
          "some_frames_wrecked": _some_frames_wrecked}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    r = _run(cell)
    assert not r["correct"], r["check"]


def test_one_wrecked_frame_in_a_long_window_reads_in_frame_mae():
    # 700 frames of radiance 0.5 at 64 pixels; frame 400 comes out black.
    # The running average moves by 0.5 / 700 at most, under the accum_mae
    # limit; the frame judged alone reads the whole 0.5.
    n, k = 700, 400
    calls = [Call((8, 8), 0, fc, 0.0) for fc in range(n)]
    truth = np.full((64, 3), 0.5, np.float32)
    ref, acc, accs = {}, np.zeros((64, 3), np.float64), []
    for fc in range(n):
        s = 0.0 if fc == k else 0.5
        acc = (acc * fc + s) / (fc + 1)
        accs.append(acc.astype(np.float32))
        ref[fc] = (truth, np.zeros((64, 3), np.uint8))
    seen = [Seen(n - 1, np.zeros((64, 3), np.uint8), accs[-1])]
    snaps = [Snap(k, accs[k - 1], accs[k]), Snap(10, accs[9], accs[10])]
    values = check.numbers(calls, seen, snaps, ref)
    limits = harness.limits_of("flagship-720p.headless")
    assert values["accum_mae"] < limits["accum_mae"], values
    assert values["frame_mae"] > 10 * limits["frame_mae"], values
    sound = check.numbers(calls, seen, snaps[1:], ref)
    assert sound["frame_mae"] < 1e-3 * limits["frame_mae"], sound


def test_without_a_card_the_run_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "c12-640x480.headless", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       cwd=pbtest.ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "c12-640x480.headless", "--seed", "4000000007",
                        "--seconds", "2", "--trace", "0"],
                       cwd=pbtest.ROOT, capture_output=True, text=True,
                       timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
