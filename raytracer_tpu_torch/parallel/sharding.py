"""Multi-GPU rendering: one process per device over ``torch.distributed``,
ranks laid out as a (dp, sp) mesh.

The port of ``raytracer_tpu/parallel/sharding.py``. JAX runs one
controller over a ``shard_map``; here each rank is a process of its own
(``launch``), because a frame is bound by the host's launches and one
Python process driving N devices would issue them in series. The mesh
axes are JAX's:

* **dp**: rank ``(d, s)`` renders rows ``d * H/dp`` to ``(d+1) * H/dp``
  of the frame (every rank holds the whole scene);
* **sp**: the ranks of one row band render disjoint slices of the
  samples (``samples_per_pixel / sp`` each, from ``s * spp/sp``).

A rank renders through the single-device pipeline
(``engine/renderer._sample_terms``: bands, tail merge, deposits) on its
rows and samples. Where sp > 1 the band's running sum passes along its
ranks in sample order: the rank of slice s adds its own per-sample colour
terms, in order, to the sum of slices 0..s-1 and broadcasts the result
over the sp group. That is the order the single-device renderer adds the
terms, so a mesh frame is bit-equal to a one-device frame for any spp that
sp divides and on every backend (an all-reduce would sum in the backend's
ring order, and a mean of partial sums would round differently). A rank
keeps its own spp/sp samples' terms until its turn, and a frame moves sp
broadcasts of one f32[3, H/dp*W] sum over each sp group, whatever the spp.
The band's running average and tonemap then run in the tonemap kernel on
each rank; the u8 rows are all-gathered over dp, so every rank holds the
frame and rank 0 writes it.

Rank ``r`` is ``(r // sp, r % sp)``, JAX's ``reshape(n // sp, sp)`` of the
device list. Backends: NCCL when every rank has a card of its own, gloo on
the CPU or when ranks share a card (NCCL refuses two ranks on one card;
gloo takes CUDA tensors). The rendezvous is a ``file://`` store in a
temporary directory: no network.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from raytracer_tpu_torch.core.types import CameraUniforms, RenderConfig
from raytracer_tpu_torch.engine.renderer import _render_total, _sample_terms
from raytracer_tpu_torch.kernels.tonemap import tonemap_accumulate
from raytracer_tpu_torch.utils.log import get_logger

_log = get_logger("mesh")


@dataclasses.dataclass
class Mesh:
    """This rank's place in a (dp, sp) mesh: its indices, its device and
    the process groups of its two axes."""

    dp: int
    sp: int
    dp_idx: int
    sp_idx: int
    device: torch.device
    dp_group: object   # the ranks of this sample slice, one per row band
    sp_group: object   # the ranks of this row band, one per sample slice

    @property
    def rank(self) -> int:
        return self.dp_idx * self.sp + self.sp_idx


def mesh_devices(n: int, devices: Optional[Sequence] = None) -> list:
    """The device of each of n ranks: ``devices[:n]`` when given, else
    ``cuda:0`` .. ``cuda:n-1``, which needs n cards."""
    if devices is not None:
        devices = [str(torch.device(d)) for d in devices]
        if len(devices) < n:
            raise ValueError(f"{n} ranks need {n} devices, got {devices}")
        return devices[:n]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > have:
        raise RuntimeError(
            f"a {n}-rank mesh needs {n} CUDA devices, this machine has "
            f"{have}; pass devices explicitly (e.g. ['cpu'] * {n}, or "
            f"['cuda:0'] * {n} to share one card)")
    return [f"cuda:{i}" for i in range(n)]


def pick_backend(devices: Sequence[str]) -> str:
    """"nccl" when every rank has a card of its own, else "gloo"."""
    devs = [torch.device(d) for d in devices]
    cards = {(d.type, d.index or 0) for d in devs}
    if all(d.type == "cuda" for d in devs) and len(cards) == len(devs):
        return "nccl"
    return "gloo"


def make_mesh(n_devices: Optional[int] = None, sp: int = 1,
              devices: Optional[Sequence] = None) -> Optional[Mesh]:
    """The (n/sp, sp) mesh over the first n ranks of the initialised
    process group (all of them by default); ``devices`` as
    ``mesh_devices``. Every rank of the group must call it (it creates
    the axes' groups); a rank past the first n gets None."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh runs inside a rank (see launch)")
    world = dist.get_world_size()
    n = n_devices or world
    if n % sp:
        raise ValueError(f"n_devices {n} not divisible by sp {sp}")
    if n > world:
        raise ValueError(f"a {n}-rank mesh in a world of {world} ranks")
    devs = mesh_devices(n, devices)
    dp = n // sp
    sp_groups = [dist.new_group(list(range(d * sp, (d + 1) * sp)))
                 for d in range(dp)]
    dp_groups = [dist.new_group(list(range(s, n, sp))) for s in range(sp)]
    rank = dist.get_rank()
    if rank >= n:
        return None
    d, s = divmod(rank, sp)
    return Mesh(dp=dp, sp=sp, dp_idx=d, sp_idx=s,
                device=torch.device(devs[rank]), dp_group=dp_groups[s],
                sp_group=sp_groups[d])


def _all_gather(t: torch.Tensor, group, size: int) -> list:
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts


class MeshRenderer:
    """The multi-device ``Renderer``: this rank's rows and samples of each
    frame (see the module docstring)."""

    def __init__(self, config: RenderConfig, mesh: Mesh):
        if config.height % (8 * mesh.dp):
            raise ValueError(f"height {config.height} must be divisible by "
                             f"8*dp ({8 * mesh.dp})")
        if config.samples_per_pixel % mesh.sp:
            raise ValueError("samples_per_pixel must be divisible by sp")
        self.cfg = config
        self.mesh = mesh
        self.shard_h = config.height // mesh.dp
        # The global spp stays: the RNG folds it into the seeds.
        self.local_cfg = dataclasses.replace(config, height=self.shard_h)
        self.spp_local = config.samples_per_pixel // mesh.sp
        _log.info("mesh renderer: dp %d, sp %d, rank %d on %s", mesh.dp,
                  mesh.sp, mesh.rank, mesh.device)

    def prepare_scene(self, scene):
        """The scene on this rank's device."""
        return scene.to(self.mesh.device)

    def new_accumulator(self) -> torch.Tensor:
        """This rank's rows of the accumulator, f32[H/dp, W, 3]."""
        return torch.zeros((self.shard_h, self.cfg.width, 3),
                           dtype=torch.float32, device=self.mesh.device)

    def full_accumulator(self, accum: torch.Tensor) -> torch.Tensor:
        """The whole f32[H, W, 3] accumulator from every band's rows (a
        collective over dp)."""
        m = self.mesh
        if m.dp == 1:
            return accum
        return torch.cat(_all_gather(accum, m.dp_group, m.dp))

    def render(self, scene, cam: CameraUniforms,
               accum: Optional[torch.Tensor] = None):
        """One frame -> (this rank's accumulator rows, updated in place;
        the whole u8 frame [H, W, 3]; stats ``rays_traced`` (the mesh's
        total, int64 tensor) and ``samples``). A collective: every rank
        of the mesh calls it with the same scene and camera."""
        m, cfg = self.mesh, self.cfg
        if accum is None:
            accum = self.new_accumulator()
        slice_ = dict(y_base=m.dp_idx * self.shard_h,
                      global_height=cfg.height,
                      sample_offset=m.sp_idx * self.spp_local,
                      n_samples=self.spp_local)
        if m.sp == 1:
            total, rays = _render_total(scene, cam, self.local_cfg,
                                        **slice_)
        else:
            terms = []
            rays = torch.zeros((), dtype=torch.int64, device=m.device)
            for sample_terms, sample_rays in _sample_terms(
                    scene, cam, self.local_cfg, **slice_):
                terms += sample_terms
                rays = rays + sample_rays
            # The running sum, slice by slice: the single-device
            # renderer's order of additions.
            total = torch.zeros_like(terms[0])
            for s in range(m.sp):
                if s == m.sp_idx:
                    for term in terms:
                        total = total + term
                dist.broadcast(total, src=m.dp_idx * m.sp + s,
                               group=m.sp_group)
            dist.all_reduce(rays, group=m.sp_group)
        if m.dp > 1:
            dist.all_reduce(rays, group=m.dp_group)
        accum, image = tonemap_accumulate(accum, total, cfg.samples_per_pixel,
                                          cam.frame_count, cam.exposure)
        if m.dp > 1:
            image = torch.cat(_all_gather(image, m.dp_group, m.dp))
        stats = {"rays_traced": rays,
                 "samples": (cam.fc_host + 1) * cfg.samples_per_pixel}
        return accum, image, stats


@dataclasses.dataclass
class LaunchResult:
    backend: str
    results: list   # fn's return value, by rank


def _rank_main(fn, rank: int, n: int, sp: int, devices: list, backend: str,
               init: str, timeout: float, out) -> None:
    """A rank's process: join the group, build the mesh, run fn(mesh),
    report (rank, error text or None, result) to the parent."""
    result, err = None, None
    try:
        dev = torch.device(devices[rank])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        dist.init_process_group(
            backend, init_method=init, rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=timeout))
        result = fn(make_mesh(n, sp, devices))
    except Exception:   # reported to the parent, which fails the launch
        err = traceback.format_exc()
    out.put((rank, err, result))
    if dist.is_initialized():
        dist.destroy_process_group()


def launch(fn: Callable, n_devices: int, sp: int = 1,
           devices: Optional[Sequence] = None,
           timeout: float = 3600.0) -> LaunchResult:
    """Run ``fn(mesh)`` on each rank of an (n/sp, sp) mesh, one process a
    rank (start method ``spawn``). ``fn`` must pickle, and so must its
    return value, which holds no tensor (a rank's tensors die with its
    process). ``devices`` as ``mesh_devices``; the backend is
    ``pick_backend``'s, never changed after a failure. A rank
    that raises, dies or outlasts ``timeout`` seconds fails the launch
    (``RuntimeError`` / ``TimeoutError``) and every rank is stopped. ->
    ``LaunchResult`` with the backend and each rank's return value."""
    import torch.multiprocessing as mp

    if n_devices % sp:
        raise ValueError(f"n_devices {n_devices} not divisible by sp {sp}")
    devs = mesh_devices(n_devices, devices)
    backend = pick_backend(devs)
    _log.info("mesh launch: %d ranks (dp %d, sp %d) on %s, backend %s",
              n_devices, n_devices // sp, sp, devs, backend)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="raytpu_mesh_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, n_devices, sp, devs, backend, init,
                               timeout, out))
             for r in range(n_devices)]
    results, done = [None] * n_devices, [False] * n_devices
    exited = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while not all(done):
            try:
                rank, err, res = out.get(timeout=0.2)
            except queue.Empty:
                now = time.monotonic()
                if now > deadline:
                    late = [r for r in range(n_devices) if not done[r]]
                    raise TimeoutError(f"mesh launch: ranks {late} did not "
                                       f"finish within {timeout} s")
                for r, p in enumerate(procs):
                    if not done[r] and p.exitcode is not None:
                        # A rank's report is in the queue before it exits.
                        if now - exited.setdefault(r, now) > 2.0:
                            raise RuntimeError(
                                f"mesh launch: rank {r} exited with code "
                                f"{p.exitcode} and no result")
                continue
            if err is not None:
                raise RuntimeError(f"mesh launch: rank {rank} failed:\n{err}")
            results[rank], done[rank] = res, True
        for p in procs:
            p.join(timeout=min(30.0, max(0.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=5.0)
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return LaunchResult(backend=backend, results=results)
