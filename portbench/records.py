"""What a driver is handed (``Env``) and what it hands back (``Window``):
every render call of the window, the frames' arrival times and the
outputs the check judges."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass
class Call:
    """One ``Renderer.render`` call."""

    size: tuple          # (width, height) of the frame rendered
    pose: int            # index into the run's poses
    fc: int              # frame counter of its uniforms
    t: float             # host seconds from the window's start
    rays: object = None  # its rays-traced tensor


@dataclasses.dataclass
class Seen:
    """An output judged whole: the render call that made it and its u8
    image and accumulator at the judged pixels."""

    call: int
    image: np.ndarray
    accum: np.ndarray


@dataclasses.dataclass
class Snap:
    """A frame judged alone: the accumulator at the first pixels of the
    judged set just before render call ``call`` (None at frame counter 0,
    which overwrites it) and just after. The two give the frame's own
    radiance, which the running average hides once it holds many frames."""

    call: int
    before: Optional[np.ndarray]
    after: np.ndarray


@dataclasses.dataclass
class Window:
    """What a run's window produced."""

    arrivals: list       # seconds from the window's start, one a frame
    calls: list          # every render call of the window, in order
    failed: int
    seen: list           # [Seen]
    snaps: list          # [Snap]


@dataclasses.dataclass
class Env:
    """What a driver needs: the program's pieces and the run's inputs."""

    Renderer: type              # the program's Renderer class
    cfg: object                 # the program's RenderConfig
    scene: object               # the program's scene on the device
    traffic: dict               # the mix's file
    make_uniforms: Callable     # (pose index, frame counter) -> uniforms
    device: str
    seed: int
    seconds: float              # the window's length
    pixels: Callable            # count -> (xs, ys), a prefix of one order
    judged: Callable            # frames in the window -> pixels judged
    window: Callable            # () -> context manager around the window
