"""A driver that changes the scene or the camera inside the window, run
whole on the CPU at the flagship's tiny size with a test driver (supplied
by name through ``byname.load``, not a file under ``drivers/``): each
render call is judged against the geometry and the pose it names. A
program that keeps rendering the previous scene or pose while the call
names the new one is not correct; a soup function that gives the same
soup under two indices judges to the bit as one index does; a span that a
driver wraps through ``env.spans`` reaches the readers and is undone after
the run."""

import time

import numpy as np
import pytest
import torch

import pbtest
from portbench import byname, check, harness, inputs
from portbench.records import Call, Seen, Snap, Window

CELL = "flagship-720p.headless"
FRAMES = 8
SHIFT = np.float32([0.0, 6.0, 0.0])   # a scene edit moves the block up
MOVE = np.float64([20.0, 0.0, 0.0])   # the camera's one move, sideways


def _moved_pose(config):
    cam, r = config["camera"], config["render"]
    return inputs.uniforms(np.asarray(cam["origin"]) + MOVE,
                           cam["look_at"], cam["v_up"],
                           float(cam["vfov_deg"]),
                           float(r["width"]) / float(r["height"]))


def _driver(edit, stale=False, restart=True, span=False):
    """A driver of FRAMES frames. ``edit="scene"``: before every other
    frame the first quarter of scene 0's triangles moves by SHIFT more,
    the program's scene rebuilt from the soup the call names; ``"pose"``:
    the camera moves once, halfway. ``stale``: the program renders the
    previous scene (pose) while the call names the new one. ``restart``:
    the frame counter restarts at each edit, else the history crosses it.
    ``span``: the rebuild is wrapped as span ``rebuild``."""

    def run(env):
        from raytracer_tpu_torch.scene import builder

        cfg = env.cfg
        size = (cfg.width, cfg.height)
        verts, mats = env.soup
        block = len(verts) // 4

        def scenes(i):
            v = verts.copy()
            v[:block] += np.float32(i) * SHIFT
            return v, mats

        if span:
            env.spans.wrap(builder, "build_fast_scene_from_arrays",
                           "rebuild")
        xs, ys = env.pixels(env.judged(FRAMES))
        flat = torch.as_tensor(ys * cfg.width + xs)
        few = flat[:int(env.traffic["check"]["frame_pixels"])]
        r = env.Renderer(cfg)
        shown, pose, scene, fc, acc = env.scene, 0, 0, 0, None
        calls, arrivals, snaps = [], [], []
        with env.window() as close:
            t0 = time.perf_counter()
            for f in range(FRAMES):
                if edit == "scene" and f and f % 2 == 0:
                    scene += 1
                    shown = builder.build_fast_scene_from_arrays(
                        *scenes(scene - 1 if stale else scene),
                        device=env.device)
                    fc = 0 if restart else fc
                if edit == "pose" and f == FRAMES // 2:
                    pose = env.add_pose(_moved_pose(env.config))
                    fc = 0 if restart else fc
                before = (None if fc == 0
                          else acc.reshape(-1, 3)[few].numpy())
                calls.append(Call(size, pose, fc, time.perf_counter() - t0,
                                  scene=scene))
                cam = env.make_uniforms(0 if stale else pose, fc)
                acc, image, stats = r.render(shown, cam, acc)
                calls[-1].rays = stats["rays_traced"]
                snaps.append(Snap(f, before, acc.reshape(-1, 3)[few].numpy()))
                arrivals.append(time.perf_counter() - t0)
                fc += 1
            close()
        seen = Seen(FRAMES - 1, image.reshape(-1, 3)[flat].numpy(),
                    acc.reshape(-1, 3)[flat].numpy())
        return Window(arrivals, calls, 0, [seen], snaps,
                      scenes=scenes if edit == "scene" else None)

    return run


def _run(monkeypatch, run, trace=False, seed=2_500_000_041):
    load = byname.load

    def patched(folder, name):
        if folder == "drivers":
            return type("Driver", (), {"run": staticmethod(run)})
        return load(folder, name)

    monkeypatch.setattr(byname, "load", patched)
    return harness.run_cell(CELL, seed, pbtest.SECONDS[CELL], trace,
                            device="cpu", override=pbtest.TINY[CELL],
                            log=lambda s: None)


@pytest.mark.parametrize("restart", [True, False])
def test_scene_edits_are_judged_against_their_own_scene(monkeypatch,
                                                        restart):
    r = _run(monkeypatch, _driver("scene", restart=restart))
    assert r["correct"], r["check"]
    assert r["attempted"] == FRAMES and r["failed"] == 0


@pytest.mark.parametrize("restart", [True, False])
def test_rendering_the_previous_scene_is_not_correct(monkeypatch, restart):
    r = _run(monkeypatch, _driver("scene", stale=True, restart=restart))
    assert not r["correct"], r["check"]


@pytest.mark.parametrize("stale", [False, True])
def test_a_pose_added_mid_window_is_judged_against_itself(monkeypatch,
                                                          stale):
    r = _run(monkeypatch, _driver("pose", stale=stale))
    assert r["correct"] is not stale, r["check"]


def _config(cell):
    bench = harness.benchmark()
    return harness._merge(harness.config_of(bench, harness.workload(
        bench, cell)), pbtest.TINY[cell]["config"])


def _judge(config, soups, seed=2_500_000_043):
    r = config["render"]
    w, h = int(r["width"]), int(r["height"])
    sh = check.pt.Shading(
        max_bounces=int(r["max_bounces"]), t_min=r["t_min"],
        t_max=r["t_max"], fuzz=r["fuzz"], det_eps=r["det_eps"],
        samples_per_pixel=int(r["samples_per_pixel"]),
        emissive_emits=r["emissive_emits"],
        fixed_light=r["shading"] == "fixed_light", sky=bool(config["sky"]),
        exposure=float(config["exposure"]))
    return check.Judge(soups, [inputs.camera(config)], sh, (w, h),
                       check.sample_pixels(seed, w, h, 64), "cpu")


@pytest.mark.parametrize("cell", sorted(pbtest.TINY))
def test_one_soup_under_two_indices_judges_to_the_bit(cell):
    config = _config(cell)
    soup = inputs.scene(config, 2_500_000_047)
    size = (int(config["render"]["width"]), int(config["render"]["height"]))
    fcs = [0, 1, 2, 3, 0, 1, 2, 3, 4, 5]
    split = [Call(size, 0, fc, 0.0, scene=k % 2)
             for k, fc in enumerate(fcs)]
    whole = [Call(size, 0, fc, 0.0) for fc in fcs]
    ks = range(len(fcs))
    two = _judge(config, lambda i: soup if i in (0, 1) else None)
    one = _judge(config, lambda i: soup if i == 0 else None)
    a, b = two.outputs(split, ks), one.outputs(whole, ks)
    assert sorted(a) == sorted(b) == list(ks)
    for k in ks:
        for x, y in zip(a[k], b[k]):
            assert x.dtype == y.dtype and np.array_equal(x, y), k


def test_a_span_wrapped_by_the_driver_reaches_the_readers(monkeypatch):
    from raytracer_tpu_torch.scene import builder

    original = builder.build_fast_scene_from_arrays
    seen = []

    def read(ctx):
        seen.append(ctx)
        return None

    monkeypatch.setattr(harness, "reader", lambda name: read)
    seed = 2_500_000_053
    r = _run(monkeypatch, _driver("scene", span=True), trace=True, seed=seed)
    assert r["correct"], r["check"]
    assert seen, "no reader ran"
    seconds, calls = seen[0].spans["rebuild"]
    assert calls == (FRAMES - 1) // 2 and seconds > 0
    # Every edit keeps the count: the mean over the calls is scene 0's.
    assert seen[0].triangles == len(inputs.scene(_config(CELL), seed)[0])
    assert builder.build_fast_scene_from_arrays is original
