"""The reference against the port's own CPU path at a tiny size, and the
bfloat16 control far from it."""

import numpy as np
import pytest
import torch

import pbtest  # noqa: F401  (import path)
from portbench import inputs
from portbench.reference import pathtracer as pt


def _port_frames(verts, mats, view, cfg_kw, frames):
    from raytracer_tpu_torch.core.types import CameraUniforms, RenderConfig
    from raytracer_tpu_torch.engine.renderer import Renderer
    from raytracer_tpu_torch.scene.builder import \
        build_fast_scene_from_arrays

    cfg = RenderConfig(width=view.width, height=view.height, **cfg_kw)
    scene = build_fast_scene_from_arrays(verts, mats, device="cpu")
    r, acc = Renderer(cfg), None
    for f in range(frames):
        cam = CameraUniforms.create(view.origin, view.lower_left_corner,
                                    view.horizontal, view.vertical,
                                    frame_count=f, device="cpu")
        acc, img, _ = r.render(scene, cam, acc)
    return acc.reshape(-1, 3).numpy(), img.reshape(-1, 3).numpy()


def _reference(verts, mats, view, sh, frames, dtype=torch.float32):
    tris = pt.Triangles(verts, mats, "cpu", dtype)
    ys, xs = np.meshgrid(np.arange(view.height), np.arange(view.width),
                         indexing="ij")
    px = torch.from_numpy(xs.ravel())
    py = torch.from_numpy(ys.ravel())
    hist = [(pt.frame_sum(tris, view, sh, px, py, torch.full_like(px, f)),
             f) for f in range(frames)]
    acc = pt.accumulate(hist, dtype)
    return acc.float().numpy(), pt.tonemap(acc).numpy()


CASES = {
    "path": ({"scene": {"kind": "terrain", "n": 12, "extent": 50.0,
                        "albedo": [0.55, 0.5, 0.45], "material": 0.0,
                        "waves": [[0.2, 0.27, 1.8], [0.27, 0.05, 2.3],
                                  [0.13, 0.12, 2.4]]},
              "camera": {"origin": [-25.0, 30.0, 140.0],
                         "look_at": [0.0, 0.0, 0.0],
                         "v_up": [0.0, 1.0, 0.0], "vfov_deg": 20.0},
              "render": {"width": 48, "height": 24}},
             {"max_bounces": 4}, pt.Shading(max_bounces=4), 3),
    "fixed_light": ({"scene": {"kind": "cube_on_plane", "cube_half": 2.0,
                               "cube_y": -6.0,
                               "plane_scale": [150.0, 1.0, 150.0],
                               "plane_y": -10.0, "max_offset": 3.0,
                               "albedo": [0.8, 0.3, 0.3], "material": 0.0},
                     "camera": {"origin": [-10.0, 6.0, 30.0],
                                "look_at": [0.0, -6.0, 0.0],
                                "v_up": [0.0, 1.0, 0.0], "vfov_deg": 40.0},
                     "render": {"width": 48, "height": 32}},
                    {"max_bounces": 1, "shading": "fixed_light"},
                    pt.Shading(max_bounces=1, fixed_light=True), 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_the_port_and_the_control_does_not(case):
    config, cfg_kw, sh, frames = CASES[case]
    verts, mats = inputs.scene(config, 987654321987)
    o, llc, hor, ver = inputs.camera(config)
    view = pt.View(o, llc, hor, ver, config["render"]["width"],
                   config["render"]["height"])
    port_acc, port_img = _port_frames(verts, mats, view, cfg_kw, frames)
    ref_acc, ref_img = _reference(verts, mats, view, sh, frames)
    acc_mae = np.abs(port_acc - ref_acc).mean()
    img_mae = np.abs(port_img.astype(int) - ref_img.astype(int)).mean()
    assert acc_mae < 1e-5 and img_mae < 0.05, (acc_mae, img_mae)
    low_acc, low_img = _reference(verts, mats, view, sh, frames,
                                  torch.bfloat16)
    low_mae = np.abs(low_acc - ref_acc).mean()
    assert low_mae > 100 * max(acc_mae, 1e-6), (low_mae, acc_mae)


def test_seed_moves_the_scene_not_its_size():
    config = CASES["path"][0]
    a, _ = inputs.scene(config, 1)
    b, _ = inputs.scene(config, 2 ** 31 + 11)
    assert a.shape == b.shape and not np.array_equal(a, b)
    assert np.array_equal(a[:, :, [0, 2]], b[:, :, [0, 2]])
    c, _ = inputs.scene(CASES["fixed_light"][0], 5)
    assert c.shape == (14, 3, 3)
