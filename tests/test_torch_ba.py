"""The port's two bundle adjusters on meshes of CPU positions against the
JAX package's on the conftest's virtual devices, in float64.

``distributed_slam_ba`` (poses + landmarks, Schur + CG) on the rig of
``tests/test_slam_ba.py`` and ``distributed_mono_ba`` (the calibration's
Schur form) on that of ``tests/test_distributed_ba.py``, each rig from its
own seed, on meshes of 1, 2 and 4 positions: poses, landmarks and
intrinsics within 1e-7 relative of the reference's on the same number of
devices (measured: 1e-15-5e-9; the CG stops after a fixed count, so its
last digits follow the order of the sums), the RMS within 1e-12, and the
results of 1, 2 and 4 positions within 1e-7 of each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _fused_rig import few_threads  # noqa: F401 (a fixture)
from stereovision_tpu.core import geometry as jgeom
from stereovision_tpu.parallel import make_mesh as j_make_mesh
from stereovision_tpu.parallel.ba import distributed_mono_ba as j_mono_ba
from stereovision_tpu.parallel.ba import mono_ba_init as j_mono_init
from stereovision_tpu.parallel.ba_landmarks import distributed_slam_ba as j_slam_ba
from stereovision_tpu_torch import parallel
from stereovision_tpu_torch.parallel import ba as pba
from stereovision_tpu_torch.parallel import ba_landmarks as pbl
from stereovision_tpu_torch.parallel import mesh as pmesh

# two intra-op threads a worker: six xdist workers share the machine's cores
pytestmark = pytest.mark.usefixtures("few_threads")

RTOL = 1e-7
MESHES = (1, 2, 4)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _meshes(n):
    return (j_make_mesh(frame=n, tile=1, devices=jax.devices()[:n]),
            parallel.make_mesh(frame=n, devices=["cpu"] * n))


@pytest.fixture(scope="module")
def sequence():
    """``tests/test_slam_ba.py``'s sequence (8 frames, 120 landmarks, 80
    slots a frame, noise 0.2 px) and its perturbed start."""
    rng = np.random.default_rng(61)
    F, L, M = 8, 120, 80
    intr = np.array([500.0, 500.0, 320.0, 240.0])
    landmarks = rng.uniform([-6, -4, 8], [6, 4, 20], (L, 3))
    poses = np.stack([np.concatenate([rng.normal(0, 0.01, 3),
                                      np.array([-0.4 * f, 0.02 * f, 0.05 * f])
                                      + rng.normal(0, 0.01, 3)]) for f in range(F)])
    uv, lid, mask = np.zeros((F, M, 2)), np.zeros((F, M), np.int32), np.zeros((F, M), bool)
    for f in range(F):
        R = np.asarray(jgeom.rodrigues(jnp.asarray(poses[f, :3])))
        cam = landmarks @ R.T + poses[f, 3:]
        p = cam[:, :2] / cam[:, 2:] * intr[:2] + intr[2:]
        vis = (cam[:, 2] > 1) & (p[:, 0] > 0) & (p[:, 0] < 640) & (p[:, 1] > 0) & (p[:, 1] < 480)
        ids = np.nonzero(vis)[0][:M]
        uv[f, :len(ids)] = p[ids] + rng.normal(0, 0.2, (len(ids), 2))
        lid[f, :len(ids)] = ids
        mask[f, :len(ids)] = True
    poses0 = poses + rng.normal(0, 0.01, poses.shape)
    poses0[0] = poses[0]
    lms0 = landmarks + rng.normal(0, 0.1, landmarks.shape)
    return intr, poses, uv, lid, mask, poses0, lms0


@pytest.fixture(scope="module")
def slam_runs(sequence):
    intr, _, uv, lid, mask, poses0, lms0 = sequence
    out = {}
    for n in MESHES:
        jm, pm = _meshes(n)
        want = j_slam_ba(jnp.asarray(uv), jnp.asarray(lid), jnp.asarray(mask), jnp.asarray(intr),
                         jnp.asarray(poses0), jnp.asarray(lms0), jm, iters=8)
        got = pbl.distributed_slam_ba(uv, lid, mask, intr, poses0, lms0, pm, iters=8)
        out[n] = ([np.asarray(w) for w in want], [g.numpy() for g in got])
    return out


@pytest.mark.parametrize("n", MESHES)
def test_slam_ba_matches_the_reference(slam_runs, sequence, n):
    (p_w, l_w, rms_w), (p_g, l_g, rms_g) = slam_runs[n]
    assert _rel(p_g, p_w) < RTOL and _rel(l_g, l_w) < RTOL
    assert abs(float(rms_g) - float(rms_w)) <= 1e-12 * float(rms_w)
    poses, poses0 = sequence[1], sequence[5]
    assert float(rms_g) < 0.5
    np.testing.assert_array_equal(p_g[0], poses0[0])  # the gauge: pose 0 frozen
    assert np.median(np.linalg.norm(p_g[:, 3:] - poses[:, 3:], axis=1)) < 0.05


def test_slam_ba_does_not_depend_on_the_mesh(slam_runs):
    base = slam_runs[1][1]
    for n in MESHES[1:]:
        for g, b in zip(slam_runs[n][1], base):
            assert _rel(g, b) < RTOL


@pytest.fixture(scope="module")
def board_views():
    """``tests/test_distributed_ba.py``'s 16 board views (640x480)."""
    rng = np.random.default_rng(31)
    K = np.array([[650.0, 0, 320], [0, 655.0, 240], [0, 0, 1]])
    dist = np.array([0.05, -0.08, 0.0005, -0.0005, 0.01])
    xs, ys = np.meshgrid(np.arange(9), np.arange(6))
    obj = np.stack([xs.ravel() * 2.5, ys.ravel() * 2.5, np.zeros(54)], -1)
    imgs = []
    while len(imgs) < 16:
        rvec = rng.uniform(-0.35, 0.35, 3)
        tvec = np.array([rng.uniform(-4, 4) - 10, rng.uniform(-3, 3) - 6.25, rng.uniform(25, 45)])
        proj = np.asarray(jgeom.project_points(jnp.asarray(obj), jnp.asarray(rvec),
                                               jnp.asarray(tvec), jnp.asarray(K),
                                               jnp.asarray(dist)))
        if proj[:, 0].min() < 5 or proj[:, 0].max() > 635 or proj[:, 1].min() < 5 \
                or proj[:, 1].max() > 475:
            continue
        imgs.append(proj + rng.normal(0, 0.05, proj.shape))
    return obj, np.asarray(imgs), K, dist


def test_mono_ba_init_matches_the_reference(board_views):
    obj, img, _, _ = board_views
    for g, w in zip(pba.mono_ba_init(obj, img, (640, 480)), j_mono_init(obj, img, (640, 480))):
        assert _rel(g, w) < 1e-12


@pytest.mark.parametrize("n", MESHES)
def test_mono_ba_matches_the_reference(board_views, n):
    obj, img, K, _ = board_views
    intr0, poses0 = j_mono_init(obj, img, (640, 480))
    jm, pm = _meshes(n)
    g_w, p_w, rms_w = j_mono_ba(jnp.asarray(obj), jnp.asarray(img), jnp.asarray(intr0),
                                jnp.asarray(poses0), jm, iters=12)
    g, p, rms = pba.distributed_mono_ba(obj, img, intr0, poses0, pm, iters=12)
    assert _rel(g, g_w) < RTOL and _rel(p, p_w) < RTOL
    assert abs(float(rms) - float(rms_w)) <= 1e-12 * float(rms_w)
    assert float(rms) < 0.12
    K_est = np.array([[g[0], 0, g[2]], [0, g[1], g[3]], [0, 0, 1]])
    np.testing.assert_allclose(K_est, K, rtol=3e-3)


def test_mono_ba_with_fixed_intrinsics(board_views):
    obj, img, K, dist = board_views
    intr = np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2], *dist])
    _, poses0 = j_mono_init(obj, img, (640, 480))
    poses0 = poses0 + np.random.default_rng(3).normal(0, 0.01, poses0.shape)
    jm, pm = _meshes(2)
    g_w, p_w, rms_w = j_mono_ba(jnp.asarray(obj), jnp.asarray(img), jnp.asarray(intr),
                                jnp.asarray(poses0), jm, iters=10, optimize_intrinsics=False)
    g, p, rms = pba.distributed_mono_ba(obj, img, intr, poses0, pm, iters=10,
                                        optimize_intrinsics=False)
    np.testing.assert_array_equal(g.numpy(), intr)  # untouched
    assert _rel(p, p_w) < RTOL and abs(float(rms) - float(rms_w)) <= 1e-12 * float(rms_w)
    assert float(rms) < 0.1


def test_psum_sums_in_position_order_and_sends_back():
    parts = [torch.full((3,), float(i)) for i in range(4)]
    out = pmesh.psum(parts)
    assert len(out) == 4 and all(torch.equal(o, torch.full((3,), 6.0)) for o in out)
    assert pmesh.psum([parts[2]])[0] is parts[2]


def test_frames_must_split_over_the_frame_axis(sequence):
    intr, _, uv, lid, mask, poses0, lms0 = sequence
    with pytest.raises(ValueError, match="do not split"):
        pbl.distributed_slam_ba(uv[:7], lid[:7], mask[:7], intr, poses0[:7], lms0,
                                parallel.make_mesh(devices=["cpu"] * 2), iters=1)
