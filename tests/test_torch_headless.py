"""The port's headless CLI: argument handling against the JAX parser, its
refusal to render on ``cuda`` without a card, a scene JSON rendered on
the CPU, checkpoint resume against a straight run, and ``--devices`` /
``--sp`` on CPU ranks against a single-device run."""

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.apps import headless


def test_parser_defaults_match_main_path():
    args = headless.build_parser().parse_args(["--flagship"])
    assert (args.width, args.height, args.max_bounces) == (1280, 720, 10)
    assert args.frames == 16 and args.exposure == 0.0 and not args.no_sky


def test_refuses_to_run_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        headless.main(["--flagship", "-o", str(tmp_path / "x.png")])
    assert not (tmp_path / "x.png").exists()


def test_rejects_zero_frames():
    with pytest.raises(SystemExit):
        headless.main(["--flagship", "--frames", "0"])


DEVICE_FLAGS = {"device"}


def test_parser_matches_the_jax_parser():
    """Every JAX option has the port's destination and default, apart
    from the device flags; the port adds only --flagship."""
    from raytracer_tpu.apps import headless as jax_headless

    def table(parser):
        return {a.dest: (a.default, tuple(a.option_strings), a.choices)
                for a in parser._actions if a.dest != "help"}

    ours, theirs = (table(headless.build_parser()),
                    table(jax_headless.build_parser()))
    assert set(ours) - set(theirs) == {"flagship"}
    for dest, spec in theirs.items():
        if dest not in DEVICE_FLAGS:
            assert ours[dest] == spec, dest
    assert ours["device"][0] == "cuda" and ours["device"][2] == ("cuda",
                                                                 "cpu")


def _scene_json(tmp_path, monkeypatch):
    """The cube_plane preset's scene saved as JSON (its meshes cached in
    a private temp dir)."""
    import tempfile

    from raytracer_tpu_torch.scene import presets

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    presets.config1_cube_plane().scene.save_json(str(tmp_path / "s.json"))
    return str(tmp_path / "s.json")


SMALL = ["--device", "cpu", "--width", "32", "--height", "16",
         "--max-bounces", "3", "--camera=-10,6,30", "--look-at=0,-6,0",
         "--vfov", "40"]


def test_scene_json_on_the_cpu_writes_a_png(tmp_path, monkeypatch, capsys):
    import json

    out = tmp_path / "x.png"
    headless.main(["--scene", _scene_json(tmp_path, monkeypatch), "-o", str(out),
                   "--frames", "2", "--stats-json", *SMALL])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["device"] == "cpu" and stats["triangles"] == 14
    assert stats["resolution"] == "32x16" and stats["samples"] == 2.0
    assert {"output", "frames", "build_ms", "render_s", "fps",
            "mrays_per_s"} <= set(stats)


def test_checkpoint_resume_equals_a_straight_run(tmp_path, monkeypatch):
    scene = _scene_json(tmp_path, monkeypatch)
    ck, straight = tmp_path / "ck.npz", tmp_path / "straight.npz"
    for _ in range(2):
        headless.main(["--scene", scene, "-o", str(tmp_path / "a.png"),
                       "--frames", "4", "--chain", "0", "--checkpoint",
                       str(ck), *SMALL])
    headless.main(["--scene", scene, "-o", str(tmp_path / "b.png"),
                   "--frames", "8", "--chain", "1", "--checkpoint",
                   str(straight), *SMALL])
    with np.load(ck) as a, np.load(straight) as b:
        assert int(a["frame_count"]) == int(b["frame_count"]) == 8
        assert a["accum"].tobytes() == b["accum"].tobytes()
        assert a["accum"].max() > 0
    assert (tmp_path / "a.png").read_bytes() == \
        (tmp_path / "b.png").read_bytes()


@pytest.mark.parametrize("flags,spp", [(["--devices", "2"], 1),
                                       (["--devices", "2", "--sp", "2"], 2)],
                         ids=["dp2", "sp2"])
def test_multi_device_png_equals_single_device(tmp_path, monkeypatch, flags,
                                               spp):
    """``--devices`` on CPU ranks over gloo: the PNG and the checkpoint's
    whole-frame accumulator are byte-equal to a single-device run's."""
    scene = _scene_json(tmp_path, monkeypatch)
    common = ["--scene", scene, "--frames", "2", "--spp", str(spp), *SMALL]
    one, mesh = tmp_path / "one", tmp_path / "mesh"
    headless.main([*common, "-o", f"{one}.png", "--checkpoint",
                   f"{one}.npz"])
    headless.main([*common, "-o", f"{mesh}.png", "--checkpoint",
                   f"{mesh}.npz", *flags])
    assert (tmp_path / "mesh.png").read_bytes() == \
        (tmp_path / "one.png").read_bytes()
    with np.load(f"{one}.npz") as a, np.load(f"{mesh}.npz") as b:
        assert a["accum"].tobytes() == b["accum"].tobytes()
        assert int(a["frame_count"]) == int(b["frame_count"]) == 2


def test_multi_device_spp_must_divide_by_sp():
    with pytest.raises(SystemExit):
        headless.main(["--default-scene", "--device", "cpu", "--devices",
                       "2", "--sp", "2", "--spp", "3"])
