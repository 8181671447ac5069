"""The port's headless CLI: argument handling and its refusal to render
without a CUDA device (it renders only on the card)."""

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
