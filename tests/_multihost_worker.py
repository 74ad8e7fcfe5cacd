"""One process of a two-process group on the CPU (gloo), for
tests/test_torch_multihost.py:

    python tests/_multihost_worker.py explicit|env RANK WORLD PORT

Joins the group (``initialize_multihost`` with a coordinator, or by
``env://``), then holds each cross-process result against the same call on
a one-process mesh of as many CPU positions, computed in this process:
``psum``, ``ppermute``, ``halo_exchange``, ``sharded_disparity``,
``sharded_disparity_exact`` and ``sharded_disparity_exact_pipelined``
(tiles and frames across the processes), ``distributed_slam_ba`` (the frame axis
across them, and a tile axis where one process owns no frame position) and
``distributed_mono_ba``. Prints one JSON line; any mismatch raises. Imports
nothing of JAX.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch


def _slam_rig():
    """A small SfM problem: 4 frames, 40 landmarks, 30 slots a frame."""
    from stereovision_tpu_torch.core import geometry as geom

    rng = np.random.default_rng(61)
    F, L, M = 4, 40, 30
    intr = np.array([500.0, 500.0, 320.0, 240.0])
    landmarks = rng.uniform([-6, -4, 8], [6, 4, 20], (L, 3))
    poses = np.stack([np.concatenate([rng.normal(0, 0.01, 3), [-0.4 * f, 0.02 * f, 0.05 * f]])
                      for f in range(F)])
    uv, lid, mask = np.zeros((F, M, 2)), np.zeros((F, M), np.int64), np.zeros((F, M), bool)
    for f in range(F):
        R = geom.rodrigues(torch.from_numpy(poses[f, :3])).numpy()
        cam = landmarks @ R.T + poses[f, 3:]
        p = cam[:, :2] / cam[:, 2:] * intr[:2] + intr[2:]
        ids = np.nonzero(cam[:, 2] > 1)[0][:M]
        uv[f, :len(ids)] = p[ids] + rng.normal(0, 0.2, (len(ids), 2))
        lid[f, :len(ids)] = ids
        mask[f, :len(ids)] = True
    poses0 = poses + rng.normal(0, 0.01, poses.shape)
    poses0[0] = poses[0]
    return uv, lid, mask, intr, poses0, landmarks + rng.normal(0, 0.1, landmarks.shape)


def _board_rig():
    """Four views of a 9x6 board through K (no distortion)."""
    from stereovision_tpu_torch.core import geometry as geom

    rng = np.random.default_rng(31)
    K = np.array([[650.0, 0, 320], [0, 655.0, 240], [0, 0, 1]])
    xs, ys = np.meshgrid(np.arange(9), np.arange(6))
    obj = np.stack([xs.ravel() * 2.5, ys.ravel() * 2.5, np.zeros(54)], -1)
    views = []
    for _ in range(4):
        rvec = rng.uniform(-0.3, 0.3, 3)
        tvec = np.array([rng.uniform(-2, 2) - 10, rng.uniform(-2, 2) - 6.25, rng.uniform(30, 40)])
        proj = geom.project_points(torch.from_numpy(obj), torch.from_numpy(rvec),
                                   torch.from_numpy(tvec), torch.from_numpy(K),
                                   torch.zeros(5, dtype=torch.float64)).numpy()
        views.append(proj + rng.normal(0, 0.05, proj.shape))
    return obj, np.asarray(views)


def _equal(got, want, what):
    for g, w in zip(got, want):
        if not (g.dtype == w.dtype and torch.equal(g, w)):
            raise AssertionError(f"{what}: the cross-process result differs from the "
                                 f"one-process mesh's (max {(g.double() - w.double()).abs().max()})")


def main():
    mode, rank, world, port = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(2)
    import torch.distributed as dist

    from stereovision_tpu_torch import parallel
    from stereovision_tpu_torch.parallel import mesh as pmesh
    from stereovision_tpu_torch.stereo import SGMParams, production_preset

    if mode == "explicit":
        pmesh.initialize_multihost(f"127.0.0.1:{port}", world, rank, device="cpu")
    else:
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, WORLD_SIZE=str(world),
                          RANK=str(rank))
        pmesh.initialize_multihost(device="cpu")
    assert dist.get_rank() == rank and dist.get_world_size() == world
    assert dist.get_backend() == "gloo"
    frames = parallel.make_mesh()
    assert frames.shape == {"frame": world, "tile": 1} and frames.spans_processes
    assert frames.ranks == tuple((r,) for r in range(world)) and frames.home.type == "cpu"
    local = parallel.make_mesh(devices=["cpu"] * world)

    # psum: every process sums the same parts in position order
    rng = np.random.default_rng(5)
    parts = [torch.from_numpy(rng.standard_normal((3, 7)).astype(np.float32))
             for _ in range(world)]
    got = pmesh.psum({rank: parts[rank]}, frames.frame_axis())
    _equal([got[rank]], [pmesh.psum(parts)[rank]], "psum")
    done = ["psum"]
    if mode == "env":
        print(json.dumps({"rank": rank, "checked": done}))
        pmesh.shutdown_multihost()
        return 0

    tiles = parallel.make_mesh(frame=1, tile=world)
    axis = tiles.tile_axis(0)
    rows = [torch.from_numpy(rng.standard_normal((2, 5)).astype(np.float32)) for _ in range(world)]
    mine = [r if k == rank else None for k, r in enumerate(rows)]
    perm = [(k, k + 1) for k in range(world - 1)]   # the first position receives nothing
    _equal([pmesh.ppermute(mine, perm, axis)[rank]], [pmesh.ppermute(rows, perm)[rank]],
           "ppermute")
    slabs = [torch.from_numpy(rng.standard_normal((6, 9)).astype(np.float32))
             for _ in range(world)]
    _equal([pmesh.halo_exchange([s if k == rank else None for k, s in enumerate(slabs)], 3,
                                axis)[rank]],
           [pmesh.halo_exchange(slabs, 3)[rank]], "halo_exchange")
    done += ["ppermute", "halo_exchange"]

    base = np.random.default_rng(7).uniform(0, 255, (2, 48, 96 + 5)).astype(np.float32)
    left, right = base[:, :, :96].copy(), base[:, :, 5:101].copy()
    prod = dataclasses.replace(production_preset(), num_disparities=32)
    for name, m_cross, m_one, p in (
            ("tiles", tiles, parallel.make_mesh(frame=1, tile=world, devices=["cpu"] * world),
             prod),
            ("frames", frames, local, SGMParams(num_disparities=16, speckle_window_size=0))):
        _equal(parallel.sharded_disparity(left, right, p, m_cross),
               parallel.sharded_disparity(left, right, p, m_one), f"sharded_disparity ({name})")
        done.append(f"sharded_disparity_{name}")
    # the exact engine, both strategies, on the tile axis and the frame axis
    # across the processes, under the plain impl and the kernel impl (their
    # plain versions on CPU tensors)
    for name, m_cross, m_one in (
            ("tiles", tiles, parallel.make_mesh(frame=1, tile=world, devices=["cpu"] * world)),
            ("frames", frames, local)):
        for fn in (parallel.sharded_disparity_exact, parallel.sharded_disparity_exact_pipelined):
            for impl in ("xla", "auto"):
                p = SGMParams(num_disparities=16, impl=impl)
                _equal(fn(left, right, p, m_cross), fn(left, right, p, m_one),
                       f"{fn.__name__} ({name}, impl={impl})")
            done.append(f"{fn.__name__}_{name}")
    rig = _slam_rig()
    for name, m_cross, m_one in (
            ("frames", frames, local),
            ("tiles", tiles, parallel.make_mesh(frame=1, tile=world, devices=["cpu"] * world))):
        _equal(parallel.distributed_slam_ba(*rig, m_cross, iters=3, cg_iters=8),
               parallel.distributed_slam_ba(*rig, m_one, iters=3, cg_iters=8),
               f"distributed_slam_ba ({name})")
        done.append(f"distributed_slam_ba_{name}")
    obj, views = _board_rig()
    intr0, poses0 = parallel.mono_ba_init(obj, views, (640, 480))
    _equal(parallel.distributed_mono_ba(obj, views, intr0, poses0, frames, iters=4),
           parallel.distributed_mono_ba(obj, views, intr0, poses0, local, iters=4),
           "distributed_mono_ba")
    done.append("distributed_mono_ba")
    print(json.dumps({"rank": rank, "checked": done}))
    pmesh.shutdown_multihost()
    return 0


if __name__ == "__main__":
    sys.exit(main())
