"""The JAX package's side of the port's tests: the jobs that a child
process runs (``torch_jax_refs`` starts it and keeps its output in the
store).

    python tests/jax_ref_jobs.py JOB IN.npz OUT.npz

loads the job's inputs (made by the test from a numpy seed), runs the JAX
package on the CPU the way its own tests do (Pallas kernels in interpret
mode, the production knobs ``RAYTPU_B0=pallas``, ``RAYTPU_BOUNCE=wave``,
``RAYTPU_TAIL_MERGE=1`` unless the job's ``env`` sets other path knobs,
``wavefront.MIN_WIDTH`` patched to 2048) and saves the results. The job
``multi`` runs several jobs of a manifest, each under its own knobs.

This file and the JAX package's sources are all the code a child runs,
so they are what ``torch_jax_refs.sources_digest`` hashes into the
store's keys: an edit here changes every key.
"""

import os
import sys

import numpy as np


def _leaves(obj, prefix=""):
    import dataclasses

    return {prefix + f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def _scene(inp):
    from raytracer_tpu.scene.builder import build_fast_scene_from_arrays

    return build_fast_scene_from_arrays(inp["verts"], inp["mats"])


def _cfg(inp):
    from raytracer_tpu.core.types import RenderConfig

    return RenderConfig(**{k[4:]: v.item() for k, v in inp.items()
                           if k.startswith("cfg_")})


def job_trace(inp):
    """Kernel A (pallas_traverse, interpret mode) on each ray set."""
    import jax.numpy as jnp

    from raytracer_tpu.kernels.pallas_trace import pallas_traverse

    scene, cfg = _scene(inp), _cfg(inp)
    out = _leaves(scene, "scene_")
    for name in ("rand", "prim"):
        rays = inp[f"{name}_rays"]
        res = pallas_traverse(
            scene, tuple(jnp.asarray(r) for r in rays[0:3]),
            tuple(jnp.asarray(r) for r in rays[3:6]),
            jnp.asarray(inp[f"{name}_active"]), cfg, interpret=True)
        out[f"{name}_out"] = np.stack(
            [np.asarray(res.closest_t), *map(np.asarray, res.normal),
             *map(np.asarray, res.mat_albedo), np.asarray(res.mat_type)])
    return out


def job_trace_shadings(inp):
    """pallas_traverse (interpret mode) on one ray set with each of the
    job's ``shadings``: "path" (normal flipped) and "fixed_light" (raw
    normal), under the job's knobs (``RAYTPU_TRAVERSE=binary`` for kernel
    5)."""
    import dataclasses

    import jax.numpy as jnp

    from raytracer_tpu.kernels.pallas_trace import pallas_traverse

    scene, cfg = _scene(inp), _cfg(inp)
    out = _leaves(scene, "scene_")
    rays = inp["rays"]
    for shading in inp["shadings"]:
        res = pallas_traverse(
            scene, tuple(jnp.asarray(r) for r in rays[0:3]),
            tuple(jnp.asarray(r) for r in rays[3:6]),
            jnp.asarray(inp["active"]),
            dataclasses.replace(cfg, shading=shading), interpret=True)
        out[f"{shading}_out"] = np.stack(
            [np.asarray(res.closest_t), *map(np.asarray, res.normal),
             *map(np.asarray, res.mat_albedo), np.asarray(res.mat_type)])
    return out


def job_bounce15(inp):
    """The colour-carrying kernel (bounce_megakernel, interpret, key_mode
    cid, sub 16) at each bcap in ``bcaps`` on one state, and the packed
    kernel (bounce_megakernel_packed) at bcap 1 on the same rays."""
    import jax.numpy as jnp

    from raytracer_tpu.kernels.pallas_mega import (bounce_megakernel,
                                                   bounce_megakernel_packed)

    scene, cfg = _scene(inp), _cfg(inp)
    out = _leaves(scene, "scene_")
    num4 = jnp.asarray(scene.num_nodes4, jnp.int32).reshape(1)
    bounds = scene.nodes8[0, :6]
    sky = jnp.asarray([int(inp["sky"])], jnp.int32)
    kw = dict(t_min=cfg.t_min, t_max=cfg.t_max, det_eps=cfg.det_eps,
              interpret=True, key_mode="cid")
    f = inp["f"]                        # f32[13, w]: o3 d3 c3 a3 act
    i = inp["i"]                        # i32[3, w]: seed bits, budget, pix
    blocks = tuple(jnp.asarray(f[j]).reshape(-1, 128) for j in range(12)) + (
        jnp.asarray(i[0]).reshape(-1, 128),
        jnp.asarray(f[12]).reshape(-1, 128),
        jnp.asarray(i[1]).reshape(-1, 128))
    for bcap in inp["bcaps"]:
        outs = bounce_megakernel(
            scene.nodes4, scene.clusters, num4, blocks,
            jnp.asarray([int(bcap)], jnp.int32), sky, bounds, 16,
            float(cfg.fuzz), bool(cfg.emissive_emits), **kw)
        out[f"b{bcap}_f"] = np.stack([np.asarray(outs[j]).reshape(-1)
                                      for j in (*range(12), 13)])
        out[f"b{bcap}_i"] = np.stack([np.asarray(outs[j]).reshape(-1)
                                      for j in (12, 14, 17)])
        out[f"b{bcap}_rays"] = np.float64(np.asarray(outs[15]).sum())
        out[f"b{bcap}_live"] = np.float64(np.asarray(outs[16]).sum())
    si = np.stack([i[0], i[2], i[2] * 3])
    sfo, sio, rays, live, key = bounce_megakernel_packed(
        scene.nodes4, scene.clusters, num4,
        jnp.asarray(f).reshape(13, -1, 128),
        jnp.asarray(si).reshape(3, -1, 128), jnp.asarray([1], jnp.int32),
        sky, bounds, 16, float(cfg.fuzz), bool(cfg.emissive_emits), **kw)
    out["packed_si_in"] = si
    out["packed_sf"] = np.asarray(sfo).reshape(13, -1)
    out["packed_si"] = np.asarray(sio).reshape(3, -1)
    out["packed_key"] = np.asarray(key).reshape(-1)
    out["packed_rays"] = np.float64(np.asarray(rays).sum())
    out["packed_live"] = np.float64(np.asarray(live).sum())
    return out


def job_bounce(inp):
    """Kernel B (bounce_megakernel12, interpret, key_mode cid, sub 16) on
    each state set, plus wavefront.sort_key in several modes."""
    import jax
    import jax.numpy as jnp

    from raytracer_tpu.kernels import wavefront
    from raytracer_tpu.kernels.pallas_mega import bounce_megakernel12

    scene, cfg = _scene(inp), _cfg(inp)
    out = _leaves(scene, "scene_")
    num4 = jnp.asarray(scene.num_nodes4, jnp.int32).reshape(1)
    bounds = scene.nodes8[0, :6]
    for name in ("uniform", "budget"):
        f = inp[f"{name}_f"]            # f32[10, w]: o3 d3 a3 act
        i = inp[f"{name}_i"]            # i32[2, w]: seed bits, budget
        blocks = tuple(jnp.asarray(f[j]).reshape(-1, 128)
                       for j in range(9)) + (
            jnp.asarray(i[0]).reshape(-1, 128),
            jnp.asarray(f[9]).reshape(-1, 128),
            jnp.asarray(i[1]).reshape(-1, 128))
        outs = bounce_megakernel12(
            scene.nodes4, scene.clusters, num4, blocks,
            jnp.asarray([int(inp["bcap"])], jnp.int32),
            jnp.asarray([int(inp["sky"])], jnp.int32), bounds, 16,
            float(cfg.fuzz), bool(cfg.emissive_emits), t_min=cfg.t_min,
            t_max=cfg.t_max, det_eps=cfg.det_eps, interpret=True,
            key_mode="cid")
        out[f"{name}_f"] = np.stack([np.asarray(outs[j]).reshape(-1)
                                     for j in (0, 1, 2, 3, 4, 5, 6, 7, 8,
                                               10)])
        out[f"{name}_i"] = np.stack([np.asarray(outs[j]).reshape(-1)
                                     for j in (9, 11, 14)])
        out[f"{name}_rays"] = np.float64(np.asarray(outs[12]).sum())
        out[f"{name}_live"] = np.float64(np.asarray(outs[13]).sum())
    o = tuple(jnp.asarray(r) for r in inp["key_o"])
    d = tuple(jnp.asarray(r) for r in inp["key_d"])
    alive = jnp.asarray(inp["key_alive"])
    smin = tuple(scene.nodes8[0, ax] for ax in range(3))
    smax = tuple(scene.nodes8[0, 3 + ax] for ax in range(3))
    for mode in ("cid", "om9"):
        for bit in (30, 31):
            k = wavefront.sort_key(o, d, alive, smin, smax, mode,
                                   dead_bit=bit)
            out[f"key_{mode}_{bit}"] = np.asarray(
                jax.lax.bitcast_convert_type(k, jnp.int32))
    return out


def job_bounce_builds(inp):
    """Kernel B's builds in interpret mode (sub 16) at bcap ``bcap`` on one
    state, f32[13, w] (o3 d3 c3 a3 act) and i32[3, w] (seed bits, budget,
    pixel id): each entry of ``builds`` is "kernel:key_mode:ordered" with
    kernel ``b12`` (bounce_megakernel12: the colour rows dropped), ``b15``
    (bounce_megakernel) or ``packed`` (bounce_megakernel_packed, si = seed,
    pixel id; no budget). Results under the entry's name: ``_f`` (the
    float rows as the kernel returns them, then alive), ``_i`` (seed,
    budget, key), ``_rays``, ``_live``."""
    import jax.numpy as jnp

    from raytracer_tpu.kernels.pallas_mega import (bounce_megakernel,
                                                   bounce_megakernel12,
                                                   bounce_megakernel_packed)

    scene, cfg = _scene(inp), _cfg(inp)
    out = _leaves(scene, "scene_")
    num4 = jnp.asarray(scene.num_nodes4, jnp.int32).reshape(1)
    bounds = scene.nodes8[0, :6]
    sky = jnp.asarray([int(inp["sky"])], jnp.int32)
    bcap = jnp.asarray([int(inp["bcap"])], jnp.int32)
    f, i = inp["f"], inp["i"]
    blk = lambda a: jnp.asarray(a).reshape(-1, 128)
    for build in inp["builds"]:
        kernel, key_mode, ordered = str(build).split(":")
        kw = dict(t_min=cfg.t_min, t_max=cfg.t_max, det_eps=cfg.det_eps,
                  interpret=True, key_mode=key_mode,
                  ordered=bool(int(ordered)))
        args = (bcap, sky, bounds, 16, float(cfg.fuzz),
                bool(cfg.emissive_emits))
        if kernel == "packed":
            sfo, sio, rays, live, key = bounce_megakernel_packed(
                scene.nodes4, scene.clusters, num4,
                jnp.asarray(f).reshape(13, -1, 128),
                jnp.asarray(i[[0, 2]]).reshape(2, -1, 128), *args, **kw)
            fl = np.asarray(sfo).reshape(13, -1)
            il = np.stack([np.asarray(sio).reshape(2, -1)[0],
                           np.full(f.shape[1], 1 << 30, np.int32),
                           np.asarray(key).reshape(-1)])
        else:
            rows = range(12) if kernel == "b15" else (*range(6), 9, 10, 11)
            nf = len(rows)
            blocks = tuple(blk(f[j]) for j in rows) + (
                blk(i[0]), blk(f[12]), blk(i[1]))
            mk = bounce_megakernel if kernel == "b15" else bounce_megakernel12
            outs = mk(scene.nodes4, scene.clusters, num4, blocks, *args,
                      **kw)
            flat = lambda j: np.asarray(outs[j]).reshape(-1)
            fl = np.stack([flat(j) for j in (*range(nf), nf + 1)])
            il = np.stack([flat(nf), flat(nf + 2), flat(nf + 5)])
            rays, live = outs[nf + 3], outs[nf + 4]
        out[f"{build}_f"] = fl
        out[f"{build}_i"] = il
        out[f"{build}_rays"] = np.float64(np.asarray(rays).sum())
        out[f"{build}_live"] = np.float64(np.asarray(live).sum())
    return out


def job_sort_keys(inp):
    """wavefront.sort_key (XLA) in every mode of ``modes`` at dead bits 30
    and 31, bit patterns as i32."""
    import jax
    import jax.numpy as jnp

    from raytracer_tpu.kernels import wavefront

    o = tuple(jnp.asarray(r) for r in inp["key_o"])
    d = tuple(jnp.asarray(r) for r in inp["key_d"])
    alive = jnp.asarray(inp["key_alive"])
    b = inp["bounds"]
    smin = tuple(jnp.float32(b[ax]) for ax in range(3))
    smax = tuple(jnp.float32(b[3 + ax]) for ax in range(3))
    out = {}
    for mode in inp["modes"]:
        for bit in (30, 31):
            k = wavefront.sort_key(o, d, alive, smin, smax, str(mode),
                                   dead_bit=bit)
            out[f"key_{mode}_{bit}"] = np.asarray(
                jax.lax.bitcast_convert_type(k, jnp.int32))
    return out


def job_tonemap(inp):
    """tonemap_accumulate (Pallas, interpret) and renderer.tonemap; with
    ``xsamples`` f32[k, H, W, 3], ``xfc`` and ``xexposure`` f32[k], also
    the accumulate + tonemap of each of those samples (``xacc_j``,
    ``ximg_j``)."""
    import jax.numpy as jnp

    from raytracer_tpu.engine.renderer import tonemap
    from raytracer_tpu.kernels.pallas_ops import tonemap_accumulate

    out = {}
    for j, (fc, ex) in enumerate(zip(inp["fc"], inp["exposure"])):
        acc, img = tonemap_accumulate(
            jnp.asarray(inp["accum"]), jnp.asarray(inp["sample"]),
            jnp.float32(fc), jnp.float32(ex), interpret=True)
        out[f"acc_{j}"] = np.asarray(acc)
        out[f"img_{j}"] = np.asarray(img)
        out[f"plain_img_{j}"] = np.asarray(
            tonemap(jnp.asarray(inp["linear"]), jnp.float32(ex)))
    for j, (fc, ex) in enumerate(zip(inp.get("xfc", ()),
                                     inp.get("xexposure", ()))):
        acc, img = tonemap_accumulate(
            jnp.asarray(inp["accum"]), jnp.asarray(inp["xsamples"][j]),
            jnp.float32(fc), jnp.float32(ex), interpret=True)
        out[f"xacc_{j}"] = np.asarray(acc)
        out[f"ximg_{j}"] = np.asarray(img)
    return out


def job_rng(inp):
    """pcg, initial_seed, the in-sphere sampler, primary rays, shade and
    camera uniforms."""
    import jax.numpy as jnp

    from raytracer_tpu.core.camera import Camera
    from raytracer_tpu.kernels import rng, tracer

    cfg = _cfg(inp)
    out = {"pcg": np.asarray(rng.pcg(jnp.asarray(inp["u32"])))}
    cam = Camera(origin=inp["cam_origin"], look_at=inp["cam_look"],
                 vfov_deg=float(inp["cam_vfov"]),
                 aspect_ratio=float(inp["cam_aspect"]))
    cam.frame_count = int(inp["fc"])
    uni = cam.uniforms()
    out.update(_leaves(uni, "cam_"))
    pixel = jnp.asarray(inp["pixel"])
    out["seed0"] = np.asarray(tracer.initial_seed(uni, cfg, pixel, 0))
    seed, (x, y, z) = rng.random_vec3_in_unit_sphere(
        jnp.asarray(inp["u32"]), jnp.asarray(inp["mask"]))
    out["sph_seed"] = np.asarray(seed)
    out["sph"] = np.stack([np.asarray(x), np.asarray(y), np.asarray(z)])
    seed, o, d = tracer.make_primary_rays(
        uni, cfg, jnp.asarray(out["seed0"]), jnp.asarray(inp["xx"]),
        jnp.asarray(inp["yy"]), int(inp["gh"]))
    out["prim_seed"] = np.asarray(seed)
    out["prim_d"] = np.stack([np.asarray(c) for c in d])
    res = tracer.TraversalResult(
        jnp.asarray(inp["hit_t"]), jnp.asarray(inp["hit_t"] < cfg.t_max),
        tuple(jnp.asarray(c) for c in inp["hit_n"]),
        tuple(jnp.asarray(c) for c in inp["hit_alb"]),
        jnp.asarray(inp["hit_mt"]))
    sh = tracer.shade(
        res, tuple(jnp.asarray(c) for c in inp["ray_o"]),
        tuple(jnp.asarray(c) for c in inp["ray_d"]),
        tuple(jnp.asarray(c) for c in inp["color"]),
        tuple(jnp.asarray(c) for c in inp["atten"]),
        jnp.asarray(inp["u32"]), jnp.asarray(inp["mask"]),
        jnp.asarray(bool(inp["sky"])), cfg)
    out["shade_f"] = np.stack([np.asarray(c) for grp in sh[:4]
                               for c in grp])
    out["shade_seed"] = np.asarray(sh[4])
    out["shade_alive"] = np.asarray(sh[5])
    return out


def job_renderer(inp):
    """The JAX Renderer, production knobs, frames 0 and 1."""
    from raytracer_tpu.engine.renderer import _num_bands
    from raytracer_tpu.kernels.packet import (tail_merge_active,
                                              tail_merge_widths)

    scene, cfg = _scene(inp), _cfg(inp)
    nb = _num_bands(cfg)
    assert tail_merge_active(scene, cfg)
    out = job_frames(inp)
    out["tail_merge_widths"] = np.asarray(
        tail_merge_widths(cfg, cfg.height // nb, nb))
    return out


def job_frames(inp):
    """The JAX Renderer under the job's knobs: ``frames`` progressive
    frames of the job's scene, config and camera."""
    import raytracer_tpu.kernels.wavefront as wf
    from raytracer_tpu.core.camera import Camera
    from raytracer_tpu.engine.renderer import Renderer

    if "RAYTPU_WAVE_MINW" not in os.environ:
        wf.MIN_WIDTH = 2048
    scene, cfg = _scene(inp), _cfg(inp)
    out = _leaves(scene, "scene_")
    cam = Camera(origin=inp["cam_origin"], look_at=inp["cam_look"],
                 vfov_deg=float(inp["cam_vfov"]),
                 aspect_ratio=cfg.width / cfg.height)
    r = Renderer(cfg)
    accum = None
    for fc in range(int(inp["frames"])):
        cam.frame_count = fc
        uni = cam.uniforms()
        out.update(_leaves(uni, f"cam{fc}_"))
        accum, image, stats = r.render(scene, uni, accum)
        out[f"accum_{fc}"] = np.asarray(accum)
        out[f"image_{fc}"] = np.asarray(image)
        out[f"rays_{fc}"] = np.float64(stats["rays_traced"])
    return out


def job_mesh(inp):
    """The JAX ``MeshRenderer`` on a (``dp``, ``sp``) mesh of virtual CPU
    devices (the child's ``XLA_FLAGS`` must force that many), production
    knobs, ``frames`` progressive frames of the job's scene, config and
    camera; the scene's tables and each frame's uniforms with them."""
    from raytracer_tpu.core.camera import Camera
    from raytracer_tpu.parallel.sharding import MeshRenderer, make_mesh

    scene, cfg = _scene(inp), _cfg(inp)
    out = _leaves(scene, "scene_")
    cam = Camera(origin=inp["cam_origin"], look_at=inp["cam_look"],
                 vfov_deg=float(inp["cam_vfov"]),
                 aspect_ratio=cfg.width / cfg.height)
    dp, sp = int(inp["dp"]), int(inp["sp"])
    r = MeshRenderer(cfg, mesh=make_mesh(n_devices=dp * sp, sp=sp))
    rscene = r.prepare_scene(scene)
    accum = None
    for fc in range(int(inp["frames"])):
        cam.frame_count = fc
        uni = cam.uniforms()
        out.update(_leaves(uni, f"cam{fc}_"))
        accum, image, stats = r.render(rscene, uni, accum)
        out[f"accum_{fc}"] = np.asarray(accum)
        out[f"image_{fc}"] = np.asarray(image)
        out[f"rays_{fc}"] = np.float64(stats["rays_traced"])
    return out


def job_chain(inp):
    """``Renderer.render_chain`` of ``k`` frames from frame count ``fc``
    over the per-ray path (a GpuScene: XLA loops, no Pallas kernel)."""
    from raytracer_tpu.core.camera import Camera
    from raytracer_tpu.engine.renderer import Renderer
    from raytracer_tpu.scene.builder import build_gpu_scene_from_arrays

    scene = build_gpu_scene_from_arrays(inp["verts"], inp["mats"])
    cfg = _cfg(inp)
    out = _gpu_leaves(scene, "scene_")
    cam = Camera(origin=inp["cam_origin"], look_at=inp["cam_look"],
                 vfov_deg=float(inp["cam_vfov"]),
                 aspect_ratio=cfg.width / cfg.height)
    cam.frame_count = int(inp["fc"])
    uni = cam.uniforms()
    out.update(_leaves(uni, "cam_"))
    accum, image, stats = Renderer(cfg).render_chain(scene, uni, None,
                                                     int(inp["k"]))
    out["accum"] = np.asarray(accum)
    out["image"] = np.asarray(image)
    out["rays"] = np.float64(stats["rays_traced"])
    out["samples"] = np.float64(stats["samples"])
    return out


def _gpu_leaves(scene, prefix):
    out = _leaves(scene.bvh, prefix)
    out.update({prefix + k: np.asarray(getattr(scene, k)) for k in (
        "tri_verts", "materials", "num_triangles", "num_nodes")})
    return out


def job_per_ray(inp):
    """The per-ray path over a GpuScene (build_gpu_scene_from_arrays):
    ``tracer.traverse`` on the job's rays under each shading,
    ``tracer.render_linear`` on the job's frame, and the scalar GLSL
    oracle (``testing/cpu_reference.py``) at ``oracle_w`` x ``oracle_h``,
    reference RNG, emissive absorbing, sky on and off."""
    import dataclasses

    import jax.numpy as jnp

    from raytracer_tpu.core.camera import Camera
    from raytracer_tpu.kernels import tracer
    from raytracer_tpu.scene.builder import build_gpu_scene_from_arrays
    from raytracer_tpu.testing import cpu_reference as oracle

    scene = build_gpu_scene_from_arrays(inp["verts"], inp["mats"])
    cfg = _cfg(inp)
    out = _gpu_leaves(scene, "scene_")
    rays = inp["rays"]
    for shading in ("path", "fixed_light"):
        res = tracer.traverse(
            scene, tuple(jnp.asarray(r) for r in rays[0:3]),
            tuple(jnp.asarray(r) for r in rays[3:6]),
            jnp.asarray(inp["active"]),
            dataclasses.replace(cfg, shading=shading))
        out[f"{shading}_out"] = np.stack(
            [np.asarray(res.closest_t), *map(np.asarray, res.normal),
             *map(np.asarray, res.mat_albedo), np.asarray(res.mat_type)])
        out[f"{shading}_hit"] = np.asarray(res.hit)
    cam = Camera(origin=inp["cam_origin"], look_at=inp["cam_look"],
                 vfov_deg=float(inp["cam_vfov"]),
                 aspect_ratio=cfg.width / cfg.height)
    cam.frame_count = int(inp["fc"])
    uni = cam.uniforms()
    out.update(_leaves(uni, "cam_"))
    image, stats = tracer.render_linear(scene, uni, cfg, sample_index=1)
    out["linear"] = np.asarray(image)
    out["rays"] = np.float64(stats["rays_traced"])
    ow, oh = int(inp["oracle_w"]), int(inp["oracle_h"])
    ocam = Camera(origin=inp["cam_origin"], look_at=inp["cam_look"],
                  vfov_deg=float(inp["cam_vfov"]), aspect_ratio=ow / oh)
    cam_np = {k: getattr(ocam, k).astype(np.float32) for k in (
        "origin", "lower_left_corner", "horizontal", "vertical")}
    for sky in (True, False):
        out[f"oracle_sky{int(sky)}"] = oracle.render_image(
            oracle.scene_to_numpy(scene), cam_np, ow, oh, max_bounces=10,
            sky_enabled=sky, emissive_emits=False)
        out.update(_leaves(ocam.uniforms(sky_enabled=sky),
                           f"ocam{int(sky)}_"))
    return out


def job_lbvh(inp):
    """bvh/lbvh.py, eager XLA (no Pallas): clz, Morton codes, the Karras
    tables of each ``codes_<name>``, ``_range_minmax`` and
    ``emit_wide_device`` over the ``codes_random`` tree, and
    ``build_fast_scene_device`` of the soup and of its first cluster."""
    import jax
    import jax.numpy as jnp

    from raytracer_tpu.bvh import lbvh

    out = {"clz": np.asarray(lbvh._clz32(jnp.asarray(inp["clz_in"]))),
           "morton": np.asarray(lbvh.morton30(
               *(jnp.asarray(a) for a in inp["unit"])))}
    for name in inp["code_sets"]:
        tables = lbvh.build_lbvh_tables(jnp.asarray(inp[f"codes_{name}"]))
        for key, t in zip(("left", "right", "first", "last", "parent"),
                          tables):
            out[f"{name}_{key}"] = np.asarray(t)
    left, right, first, last, parent = (
        jnp.asarray(out[f"random_{k}"])
        for k in ("left", "right", "first", "last", "parent"))
    mn, mx = lbvh._range_minmax(jnp.asarray(inp["leaf_lo"]),
                                jnp.asarray(inp["leaf_hi"]), first, last)
    out["range_min"], out["range_max"] = np.asarray(mn), np.asarray(mx)
    table, n_wide = lbvh.emit_wide_device(
        left, right, parent, jnp.asarray(inp["all_lo"]),
        jnp.asarray(inp["all_hi"]), int(inp["codes_random"].shape[0]))
    out["wide_table"], out["wide_n"] = np.asarray(table), np.asarray(n_wide)
    build = jax.jit(lbvh.build_fast_scene_device)
    for tag, n in (("soup", None), ("one", 8)):
        fs = build(jnp.asarray(inp["verts"][:n]), jnp.asarray(
            inp["mats"][:n]))
        out.update(_leaves(fs, f"{tag}_"))
    return out


def job_lbvh_scene(inp):
    """``jax.jit`` of ``lbvh.build_fast_scene_device`` on the soup (T a
    multiple of 8), under the child's layout knobs (XLA, no Pallas)."""
    import jax
    import jax.numpy as jnp

    from raytracer_tpu.bvh import lbvh

    fs = jax.jit(lbvh.build_fast_scene_device)(jnp.asarray(inp["verts"]),
                                               jnp.asarray(inp["mats"]))
    return _leaves(fs, "lbvh_")


def job_ploc_device(inp):
    """bvh/ploc_device.py, eager XLA (no Pallas): ``jax.jit`` of
    ``build_fast_scene_device_ploc`` on each soup ``verts_<name>`` /
    ``mats_<name>`` of ``soups``."""
    import jax
    import jax.numpy as jnp

    from raytracer_tpu.bvh.ploc_device import build_fast_scene_device_ploc

    build = jax.jit(build_fast_scene_device_ploc)
    out = {}
    for name in inp["soups"]:
        fs = build(jnp.asarray(inp[f"verts_{name}"]),
                   jnp.asarray(inp[f"mats_{name}"]))
        out.update(_leaves(fs, f"{name}_"))
    return out


def job_instanced(inp):
    """scene/instanced.py: ``prep_mesh_blas`` of each ``mesh_<i>`` and
    ``combine_instanced`` for each ``k_<k>`` (mesh index per instance)
    with params ``params_<k>`` f32[k, 10] (XLA, no Pallas)."""
    import jax.numpy as jnp

    from raytracer_tpu.scene import instanced

    out = {}
    blases = []
    for i in range(int(inp["n_meshes"])):
        b = instanced.prep_mesh_blas(inp[f"mesh_{i}"])
        blases.append(b)
        out.update(_leaves(b, f"blas{i}_"))
    for k in inp["ks"]:
        p = inp[f"params_{k}"]
        params = [(jnp.asarray(r[0:3]), jnp.asarray(r[3:6]),
                   jnp.asarray(r[6:9]), jnp.asarray(r[9])) for r in p]
        fs = instanced.combine_instanced(
            [blases[i] for i in inp[f"k_{k}"]], params)
        out.update(_leaves(fs, f"k{k}_"))
    return out


def job_refit(inp):
    """scene/refit.py: ``capture_refit`` of ``mesh_<i>`` under
    ``params`` f32[I, 10] with each method of ``methods``, its tables,
    and ``refit`` at the capture params and at ``moved`` (XLA, no
    Pallas)."""
    from raytracer_tpu.scene import refit

    names = ("v_base", "inst_slot", "slot_valid", "skip_col", "col7_col",
             "first", "last", "row_valid", "wide_rows", "wide_meta",
             "num_nodes", "n_wide", "num_tris")
    meshes = [inp[f"mesh_{i}"] for i in range(int(inp["n_meshes"]))]

    def tuples(p):
        return [(r[0:3], r[3:6], r[6:9], r[9]) for r in p]

    out = {}
    for method in inp["methods"]:
        method = str(method)
        cap = refit.capture_refit(meshes, tuples(inp["params"]),
                                  method=method)
        for name, t in zip(names, cap.tables):
            out[f"{method}_cap_{name}"] = np.asarray(t)
        for tag in ("params", "moved"):
            out.update(_leaves(cap.refit(tuples(inp[tag])),
                               f"{method}_{tag}_"))
    return out


def job_mega(inp):
    """kernels/packet.py's XLA functions (no Pallas): ``ray_traverse_fast``
    on ``rays`` / ``active`` under path and fixed-light shading,
    ``packet_traverse`` on the groups ``g_rays`` f32[6, 64, NG] /
    ``g_active``, ``megakernel_bounces`` from each bounce of ``starts`` on
    the ``m_*`` state (pixel ids ``m_pix``) under the job's compaction
    knobs."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from raytracer_tpu.kernels import packet

    scene, cfg = _scene(inp), _cfg(inp)
    out = _leaves(scene, "scene_")
    v3 = lambda a: tuple(jnp.asarray(c) for c in a)

    def result(res):
        return np.stack([np.asarray(res.closest_t),
                         *map(np.asarray, res.normal),
                         *map(np.asarray, res.mat_albedo),
                         np.asarray(res.mat_type)])

    r = inp["rays"]
    for shading in ("path", "fixed_light"):
        res = packet.ray_traverse_fast(
            scene, v3(r[0:3]), v3(r[3:6]), jnp.asarray(inp["active"]),
            dataclasses.replace(cfg, shading=shading))
        out[f"fast_{shading}"] = result(res)
        out[f"fast_{shading}_hit"] = np.asarray(res.hit)
    g = inp["g_rays"]
    res = packet.packet_traverse(scene, v3(g[0:3]), v3(g[3:6]),
                                 jnp.asarray(inp["g_active"]), cfg)
    out["packet"] = result(res)
    out["packet_hit"] = np.asarray(res.hit)
    m = inp["m_f"]                       # f32[12, P]: o, d, colour, atten
    for s in inp["starts"]:
        def mega(o, d, c, a, seed, alive, pix, s=int(s)):
            return packet.megakernel_bounces(
                scene, o, d, c, a, seed, alive, bool(inp["sky"]), cfg,
                start_bounce=s, pix=pix)

        cx, cy, cz, rays = jax.jit(mega)(
            v3(m[0:3]), v3(m[3:6]), v3(m[6:9]), v3(m[9:12]),
            jnp.asarray(inp["m_seed"]), jnp.asarray(inp["m_alive"]),
            jnp.asarray(inp["m_pix"]))
        out[f"mega{s}_color"] = np.stack([np.asarray(c)
                                          for c in (cx, cy, cz)])
        out[f"mega{s}_rays"] = np.float64(rays)
    return out


def job_host_bvh(inp):
    """The host builds under the job's knobs (``RAYTPU_BVH``,
    ``RAYTPU_NATIVE``, ``RAYTPU_LEAF_COUNTS``): ``bvh.build.build_bvh`` of
    the soup at leaf size 8 and ``build_fast_scene_from_arrays``."""
    import dataclasses

    from raytracer_tpu.bvh.build import build_bvh

    bvh = build_bvh(inp["verts"], leaf_size=8)
    out = {f"bvh_{f.name}": np.asarray(getattr(bvh, f.name))
           for f in dataclasses.fields(bvh)}
    out.update(_leaves(_scene(inp), "scene_"))
    return out


def job_multi(inp):
    """Each job of the manifest (``run_jobs``) under its own knobs; its
    results under the prefix ``j<index>_``."""
    import json

    with open(str(inp["manifest"])) as f:
        specs = json.load(f)
    out = {}
    for j, spec in enumerate(specs):
        saved = {k: os.environ.get(k) for k in spec["env"]}
        os.environ.update(spec["env"])
        try:
            with np.load(spec["src"]) as f:
                res = JOBS[spec["job"]]({k: f[k] for k in f.files})
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        out.update({f"j{j}_{k}": v for k, v in res.items()})
    return out


JOBS = {"trace": job_trace, "bounce": job_bounce,
        "tonemap": job_tonemap, "rng": job_rng, "renderer": job_renderer,
        "trace_shadings": job_trace_shadings, "bounce15": job_bounce15,
        "frames": job_frames, "mesh": job_mesh, "chain": job_chain,
        "per_ray": job_per_ray,
        "lbvh": job_lbvh, "lbvh_scene": job_lbvh_scene,
        "ploc_device": job_ploc_device,
        "instanced": job_instanced, "refit": job_refit,
        "mega": job_mega, "host_bvh": job_host_bvh,
        "bounce_builds": job_bounce_builds, "sort_keys": job_sort_keys,
        "multi": job_multi}


if __name__ == "__main__":
    job, src, dst = sys.argv[1:4]
    with np.load(src) as f:
        inputs = {k: f[k] for k in f.files}
    np.savez(dst, **JOBS[job](inputs))
