"""Shared rig of the fused-pipeline parity tests: the identity-rectified
256x192 calibration of tests/test_pipeline.py, its textured pairs, the
reference's hypothesis draws handed to the port, and the comparison of a
fused frame."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovision_tpu.core import geometry as jgeom

W, H = 256, 192
# a fused value may sit on a threshold inside fuse_depth_maps (fused < 15
# for the flow fill, fill_w > 0.1 for the MiDaS fill, max > 10 for the
# bilateral): a last-ulp difference then flips the pixel's branch. Such
# pixels are bounded at 0.1% of a frame.
FLIP_SHARE = 1e-3


BUNDLED = (Path(__file__).resolve().parents[1] / "stereovision_tpu" / "models" / "pretrained"
           / "midas_synthetic.msgpack")


def reference_model(*args, **kwargs):
    """Stands in for the reference's ``mono.nn.create_model()`` (the default
    arch, pretrained): the same (MidasSmall(), variables) pair, the
    variables read straight from the bundled checkpoint. The reference
    first runs a random ``init`` that the checkpoint then overwrites; its
    compile takes ~25 s a process."""
    assert not args and set(kwargs) <= {"arch", "torch_state_dict"}, kwargs
    assert kwargs.get("arch", "small") == "small" and kwargs.get("torch_state_dict") is None
    from flax import serialization

    from stereovision_tpu.models.midas import MidasSmall

    return MidasSmall(), jax.device_put(serialization.msgpack_restore(BUNDLED.read_bytes()))


def rig_calibration():
    K = np.array([[250.0, 0, 128], [0, 250.0, 96], [0, 0, 1]])
    T = np.array([-5.0, 0.0, 0.0])
    d0 = np.zeros(5)
    R1, R2, P1, P2, Q = jgeom.stereo_rectify(
        jnp.asarray(K), jnp.asarray(d0), jnp.asarray(K), jnp.asarray(d0),
        (W, H), jnp.eye(3), jnp.asarray(T), alpha=0.0)
    return {"mtx_left": K, "mtx_right": K, "dist_left": d0, "dist_right": d0, "R": np.eye(3),
            "T": T.reshape(3, 1), "R1": np.asarray(R1), "R2": np.asarray(R2),
            "P1": np.asarray(P1), "P2": np.asarray(P2), "Q": np.asarray(Q),
            "img_size": np.asarray([W, H])}


def stereo_pair(rng, disp=8):
    from scipy.signal import convolve2d

    base = rng.uniform(0, 255, (H, W + disp + 4)).astype(np.float32)
    base = convolve2d(base, np.ones((5, 5), np.float32) / 25.0, mode="same",
                      boundary="symm").astype(np.float32)
    return base[:, :W], base[:, disp:disp + W]


def sharp_pair(rng):
    """Sharp, high-contrast texture: the unoccluded camera scores far
    below the 0.6x asymmetry guard."""
    sharp = rng.uniform(0, 255, (H, W + 8)).astype(np.float32)
    return sharp[:, :W], sharp[:, 8:W + 8]


@pytest.fixture(scope="module", autouse=False)
def few_threads():
    """Two intra-op threads for the module's port frames, restored after:
    these files run beside five other workers, where each torch pool of a
    thread a core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class ReferenceDraws:
    """Replaces ``mono.ego.draw_hypotheses``: each port generator (one a
    pipeline's flow state) gets the hypotheses the reference draws from
    ``PRNGKey(0)``, split once a frame, in its order."""

    def __init__(self):
        self.keys = {}

    def __call__(self, generator, n_hyp, n):
        key = self.keys.get(id(generator), jax.random.PRNGKey(0))
        key, sub = jax.random.split(key)
        self.keys[id(generator)] = key
        return torch.from_numpy(np.array(jax.random.randint(sub, (n_hyp, 4), 0, n), np.int64))


def assert_frame_close(got: dict, ref: dict, what: str):
    """``mode`` (and ``occlusion``/``occlusion_code``, ``camera_moving``)
    exact; ``fused`` within 0.1 on the 0-255 scale and ``meters`` within
    rtol 1e-4 except on branch-flipped pixels (``FLIP_SHARE``). Meters are
    f·B/disparity of the fused value, so a fused difference δ at value v
    moves them by δ/v relatively (0.1 at v = 55 is 1.8e-3): they are held
    to rtol 1e-4 beyond that share."""
    for key in ("mode", "camera_moving", "occlusion_code"):
        if key in ref:
            np.testing.assert_array_equal(np.asarray(got[key].cpu()), np.asarray(ref[key]),
                                          err_msg=f"{what}: {key}")
    if "occlusion" in ref:
        assert got["occlusion"] == ref["occlusion"], what
    f_got, f_ref = got["fused"].cpu().numpy(), np.asarray(ref["fused"])
    m_got, m_ref = got["meters"].cpu().numpy(), np.asarray(ref["meters"])
    assert f_got.shape == f_ref.shape, what
    flipped = np.abs(f_got - f_ref) > 0.1
    assert flipped.mean() <= FLIP_SHARE, (
        f"{what}: {flipped.sum()} pixels of fused differ by more than 0.1 "
        f"(max {np.abs(f_got - f_ref).max()})")
    ok = ~flipped
    carried = np.abs(f_got - f_ref) / np.maximum(f_ref, 1e-3)
    excess = np.abs(m_got - m_ref) / m_ref - carried
    assert excess[ok].max() <= 1e-4, f"{what}: meters differ by rtol {excess[ok].max()} " \
                                     "beyond what the fused difference carries"
    return np.abs(f_got - f_ref).max()
