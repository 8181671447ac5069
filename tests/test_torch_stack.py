"""The walk's stack need (``bvh4.nodes4_stack_need``) on the CPU.

Kernels A and B give each thread ``STACK_CAP`` (256) stack slots in local
memory, so every table they walk must need no more: the need is
``(W - 1) * (max depth + 1) + 1`` for a W-wide tree (7 a level at width
8, 15 at width 16), ``collapse4`` refuses the trees it would build deeper
and ``fast_scene_from_numpy`` the tables it is handed, and the plain walk
(``trace.walk_plain``, which reports its deepest stack as
``launches.work["stack4_max"]``) never goes past the need, on random rays
and on hand-built trees deep enough to come within 7 slots of it (width
8) or to need all 256 (width 16). No JAX: the tables are the port's own.
"""

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.bvh.bvh4 import (STACK_CAP, collapse4,
                                          nodes4_stack_need)
from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.kernels import launches
from raytracer_tpu_torch.kernels.bounce import bounce12, pack_state
from raytracer_tpu_torch.kernels.trace import trace4
from raytracer_tpu_torch.scene import presets
from raytracer_tpu_torch.scene.builder import (build_fast_scene_from_arrays,
                                               fast_scene_from_numpy)
from raytracer_tpu_torch.utils import assets

torch.set_num_threads(2)

P = 1024


def _terrain():
    verts = assets.make_terrain(n=32, extent=30.0)
    cube = assets.make_cube() * 8.0 + np.array([5.0, 8.0, -3.0], np.float32)
    verts = np.concatenate([verts, cube]).astype(np.float32)
    mats = np.zeros((verts.shape[0], 4), np.float32)
    mats[:, 0:3] = 0.5
    return verts, mats


def _cube_plane():
    return presets.c12_arrays()


def _max_depth(nodes4) -> int:
    """Deepest wide node below the root (root at 0), by an explicit
    depth-first search over the internal children."""
    rows = np.asarray(nodes4).reshape(-1, 8, 16)
    deepest, todo = 0, [(0, 0)]
    while todo:
        nid, depth = todo.pop()
        deepest = max(deepest, depth)
        todo += [(int(m) - 1, depth + 1) for m in rows[nid, :, 6] if m > 0]
    return deepest


def _leaves(scene) -> dict:
    """The FastScene leaves ``fast_scene_from_numpy`` takes."""
    leaves = {n: getattr(scene, n).numpy()
              for n in ("nodes8", "clusters", "nodes4")}
    leaves.update(num_nodes=scene.num_nodes,
                  num_triangles=scene.num_triangles,
                  num_nodes4=scene.num_nodes4)
    return leaves


def _random_rays(scene, n, seed):
    r = np.random.default_rng(seed)
    n4 = scene.nodes4.numpy()[:scene.num_nodes4].reshape(-1, 8, 16)
    lo, hi = n4[0, :, 0:3].min(0) - 5, n4[0, :, 3:6].max(0) + 5
    o = r.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = r.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = np.ascontiguousarray(np.concatenate([o.T, d.T]))
    return torch.from_numpy(rays)


@pytest.mark.parametrize("make", [_terrain, _cube_plane],
                         ids=["terrain32", "cube_plane"])
def test_need_is_seven_per_level_and_both_builders_agree(make):
    scene = build_fast_scene_from_arrays(*make(), device="cpu")
    need = nodes4_stack_need(scene.nodes4.numpy(), 8)
    assert need == 7 * (_max_depth(scene.nodes4) + 1) + 1 <= STACK_CAP
    again = fast_scene_from_numpy(_leaves(scene), device="cpu")
    for name in ("nodes8", "clusters", "nodes4"):
        assert torch.equal(getattr(again, name).view(torch.int32),
                           getattr(scene, name).view(torch.int32))


def test_empty_scene_needs_one_level():
    scene = build_fast_scene_from_arrays(np.zeros((0, 3, 3), np.float32),
                                         np.zeros((0, 4), np.float32),
                                         device="cpu")
    assert nodes4_stack_need(scene.nodes4.numpy(), 8) == 8


def test_walk_stays_inside_the_need_on_random_rays():
    scene = build_fast_scene_from_arrays(*_terrain(), device="cpu")
    rays = _random_rays(scene, P, 7)
    launches.reset()
    out = trace4(scene, rays, torch.ones(P, dtype=torch.bool),
                 RenderConfig())
    deepest = launches.work["stack4_max"]
    assert (out[0] < RenderConfig().t_max).float().mean() > 0.2
    assert 1 <= deepest <= nodes4_stack_need(scene.nodes4.numpy(), 8)


def test_deep_tree_reaches_close_to_its_need():
    """36 chain levels: need 253, and the walk reaches 7 * 34 + 8 = 246
    slots (the deepest level pushes no internal child)."""
    scene, rays = presets.stack_limit_scene(64, device="cpu")
    assert _max_depth(scene.nodes4) == 35
    assert nodes4_stack_need(scene.nodes4.numpy(), 8) == 253 <= STACK_CAP
    cfg = RenderConfig()
    launches.reset()
    out = trace4(scene, rays, torch.ones(64, dtype=torch.bool), cfg)
    assert launches.work["stack4_max"] == 246
    hit = out[0] < cfg.t_max
    assert int(hit.sum()) == 56 and not hit[::8].any()
    # The winner is cluster 1's z = 12 triangle, in its second half.
    assert (out[7][hit] == 2.0).all()

    n = 64
    seed = torch.arange(n, dtype=torch.int64) * 2654435761 % 2 ** 32
    state = pack_state(tuple(rays[0:3]), tuple(rays[3:6]),
                       (torch.ones(n),) * 3, seed,
                       torch.ones(n, dtype=torch.bool), 4,
                       torch.arange(n, dtype=torch.int32))
    launches.reset()
    _, _, counts = bounce12(scene, state, 2, True, cfg)
    assert launches.work["stack4_max"] == 246
    assert counts[0] >= n


def test_walk_counts_only_the_live_work():
    """The work ``walk_plain`` counts (what ``chip_smoke.py`` prices for
    the kernels' bound) on the deep tree, worked out by hand: a ray that
    hits visits the 36 chain nodes and 245 small nodes (8 live slots a
    chain level, 2 at the last and in each small node), runs the network
    at the 35 levels that push 8 children, and tests each of its 246
    pairs of leaves' 1 + 6 live triangles; a ray that misses visits the
    root's 8 slots only."""
    scene, rays = presets.stack_limit_scene(64, device="cpu")
    launches.reset()
    trace4(scene, rays, torch.ones(64, dtype=torch.bool), RenderConfig())
    hits, misses = 56, 8
    assert launches.work["visits4"] == hits * (36 + 245) + misses
    assert launches.work["slots4"] == (hits * (35 * 8 + 2 + 245 * 2)
                                       + misses * 8)
    assert launches.work["nets4"] == hits * 35
    assert launches.work["tris"] == hits * 246 * 7


def test_tables_deeper_than_the_stack_are_refused():
    """One level more under the 36-level chain needs 260 > 256 slots:
    ``fast_scene_from_numpy`` refuses it, and a cyclic table too."""
    scene, _ = presets.stack_limit_scene(8, device="cpu")
    leaves = _leaves(scene)
    fast_scene_from_numpy(leaves, device="cpu")
    n4 = leaves["nodes4"]
    deepest = presets.CHAIN_LEVELS[8] - 1  # the chain's rows come first
    extra = np.zeros((1, n4.shape[1]), np.float32)
    extra[0, 0:7] = n4[deepest, 0:7]       # its first leaf child
    n4 = np.concatenate([n4, extra])
    n4[deepest, 32:38] = n4[deepest, 0:6]
    n4[deepest, 38] = n4.shape[0]          # internal child: the new row
    assert nodes4_stack_need(n4, 8) == 260
    for table in (n4, np.where(np.arange(n4.shape[1]) == 38, 1.0, n4)):
        with pytest.raises(ValueError, match="stack slots"):
            fast_scene_from_numpy(dict(leaves, nodes4=table, num_nodes4=
                                       table.shape[0]), device="cpu")


def _caterpillar(levels: int) -> np.ndarray:
    """Binary nodes8 of a caterpillar: ``levels`` internal nodes, each
    with a leaf left child and the next internal node (the last: a leaf)
    right, in pre-order with skip links."""
    m = 2 * levels + 1
    nodes8 = np.zeros((m, 8), np.float32)
    nodes8[:, 0:3], nodes8[:, 3:6] = -1.0, 1.0
    skip = np.full(m, m, np.int32)
    col7 = np.zeros(m, np.int32)
    for k in range(levels):
        col7[2 * k] = -(2 * k + 1) - 1           # left child: the next row
        skip[2 * k + 1] = 2 * k + 2              # the leaf skips right
        col7[2 * k + 1] = k
    col7[m - 1] = levels
    nodes8[:, 6] = skip.view(np.float32)
    nodes8[:, 7] = col7.view(np.float32)
    return nodes8


@pytest.mark.parametrize("width,levels,need", [(8, 7 * 36, 253),
                                               (16, 15 * 17, 256)],
                         ids=["w8", "w16"])
def test_collapse_refuses_past_the_stack_at_each_width(width, levels, need):
    """A caterpillar whose W-wide collapse takes W - 1 binary levels a
    wide node: at the deepest tree that fits, the need is 253 (width 8)
    or exactly 256 (width 16) and the table is built; one wide level more
    is refused."""
    nodes8 = _caterpillar(levels)
    table, n4, depth = collapse4(nodes8, nodes8.shape[0], None,
                                 cluster_size=8, width=width,
                                 return_depth=True)
    assert table.shape == (n4 * width // 8, 128)
    assert nodes4_stack_need(table, width) == need <= STACK_CAP
    deeper = _caterpillar(levels + width - 1)
    with pytest.raises(ValueError, match="STACK_CAP"):
        collapse4(deeper, deeper.shape[0], None, cluster_size=8,
                  width=width)


def test_16_wide_deep_tree_needs_the_whole_stack():
    """The width-16 stack-limit tree: 17 chain levels of 16 children need
    all 256 slots; the walk reaches 15 * 15 + 16 = 241 and finds the same
    winner as the 8-wide tree; ``fast_scene_from_numpy`` takes the table
    at width 16 and refuses it one level deeper (271 slots)."""
    scene, rays = presets.stack_limit_scene(64, device="cpu", width=16)
    assert scene.layout == (8, 16) and scene.nodes4.shape[1] == 128
    assert nodes4_stack_need(scene.nodes4.numpy(), 16) == 256
    cfg = RenderConfig()
    launches.reset()
    out = trace4(scene, rays, torch.ones(64, dtype=torch.bool), cfg)
    assert launches.work["stack4_max"] == 241
    assert launches.work["nets16"] == 56 * 16 and "nets4" not in \
        launches.work
    want = trace4(*presets.stack_limit_scene(64, device="cpu")[:1], rays,
                  torch.ones(64, dtype=torch.bool), cfg)
    assert torch.equal(out, want)

    leaves = _leaves(scene)
    fast_scene_from_numpy(leaves, device="cpu", layout=(8, 16))
    n4 = leaves["nodes4"].reshape(-1, 256)
    deepest = presets.CHAIN_LEVELS[16] - 1
    extra = np.zeros((1, 256), np.float32)
    extra[0, 0:7] = n4[deepest, 0:7]
    n4 = np.concatenate([n4, extra])
    n4[deepest, 32:38] = n4[deepest, 0:6]
    n4[deepest, 38] = n4.shape[0]
    n4 = n4.reshape(-1, 128)
    assert nodes4_stack_need(n4, 16) == 271
    with pytest.raises(ValueError, match="stack slots"):
        fast_scene_from_numpy(dict(leaves, nodes4=n4,
                                   num_nodes4=n4.shape[0] // 2),
                              device="cpu", layout=(8, 16))
