"""The port's DepthPipeline against the JAX package's, and the port's
independence from JAX.

The identity rig of tests/test_pipeline.py (256x192, 32 disparities, LR
check off) goes through both pipelines, the calibration carried across with
``convert.calibration_from_numpy``: ``valid`` agrees on at least 99.9% of
the pixels, disparity within 1e-4 where both are valid, and the recovered
disparity and depth hold the reference test's checks. The production
configuration (64 disparities) goes through both on the same rig.
"""

import ast
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovision_tpu.core import geometry as jgeom
from stereovision_tpu_torch import convert
from stereovision_tpu_torch.io.store import CalibrationStore

REPO = Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(81)
W, H, DISP = 256, 192, 8


@pytest.fixture(scope="module")
def rig_calibration():
    K = np.array([[250.0, 0, 128], [0, 250.0, 96], [0, 0, 1]])
    R = np.eye(3)
    T = np.array([-5.0, 0.0, 0.0])
    d0 = np.zeros(5)
    R1, R2, P1, P2, Q = jgeom.stereo_rectify(
        jnp.asarray(K), jnp.asarray(d0), jnp.asarray(K), jnp.asarray(d0),
        (W, H), jnp.asarray(R), jnp.asarray(T), alpha=0.0)
    return {
        "mtx_left": K, "mtx_right": K, "dist_left": d0, "dist_right": d0,
        "R": R, "T": T.reshape(3, 1),
        "R1": np.asarray(R1), "R2": np.asarray(R2),
        "P1": np.asarray(P1), "P2": np.asarray(P2), "Q": np.asarray(Q),
        "img_size": np.asarray([W, H]),
    }


def stereo_pair(disp=DISP):
    from scipy.signal import convolve2d

    base = RNG.uniform(0, 255, (H, W + disp + 4)).astype(np.float32)
    base = convolve2d(base, np.ones((5, 5), np.float32) / 25.0, mode="same",
                      boundary="symm").astype(np.float32)
    return base[:, :W], base[:, disp:disp + W]


def _params():
    from stereovision_tpu_torch.stereo import SGMParams

    return SGMParams(num_disparities=32, lr_max_diff=-1)


@pytest.fixture(scope="module")
def both_results(rig_calibration):
    from stereovision_tpu.pipeline import DepthPipeline as JDepthPipeline
    from stereovision_tpu.stereo import SGMParams as JSGMParams
    from stereovision_tpu_torch.pipeline import DepthPipeline

    left, right = stereo_pair()
    jp = JSGMParams(num_disparities=32, lr_max_diff=-1, impl="xla")
    ref = JDepthPipeline(rig_calibration, jp, min_depth=0.1, max_depth=5.0)(left, right)
    pipe = DepthPipeline(convert.calibration_from_numpy(rig_calibration, "cpu"),
                         convert.sgm_params_from_dict(dataclasses.asdict(jp)),
                         min_depth=0.1, max_depth=5.0, device="cpu")
    res = pipe(left, right)
    return pipe, res, ref, (left, right)


def test_pipeline_matches_reference(both_results):
    _, res, ref, _ = both_results
    d, dr = res.disparity.numpy(), np.asarray(ref.disparity)
    v, vr = d > -1.0, dr > -1.0
    assert (v == vr).mean() >= 0.999
    both = v & vr
    np.testing.assert_allclose(d[both], dr[both], atol=1e-4, rtol=0)
    c, cr = res.confidence.numpy(), np.asarray(ref.confidence)
    assert (c == cr).mean() >= 0.999
    z, zr = res.depth_m.numpy(), np.asarray(ref.depth_m)
    ok = (c > 0) & (cr > 0)
    np.testing.assert_allclose(z[ok], zr[ok], rtol=1e-5)


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_pipeline_recovers_the_shift(both_results, impl):
    """The reference test's checks (tests/test_pipeline.py), on both of the
    port's paths."""
    pipe, res, _, (left, right) = both_results
    if impl == "xla":
        pipe.params = dataclasses.replace(pipe.params, impl="xla")
        try:
            res = pipe(left, right)
        finally:
            pipe.params = dataclasses.replace(pipe.params, impl="auto")
    d = res.disparity.numpy()[20:-20, 40:-20]
    c = res.confidence.numpy()[20:-20, 40:-20]
    assert abs(np.median(d[c > 0]) - DISP) < 0.5
    # depth = f*B/d = 250 * 0.05 / 8 = 1.5625 m
    z = res.depth_m.numpy()[20:-20, 40:-20]
    assert abs(np.median(z[z > 0]) - 1.5625) < 0.05


def test_point_cloud_matches_reference(both_results, rig_calibration):
    from stereovision_tpu.core import geometry as jg

    pipe, res, _, _ = both_results
    cloud = pipe.point_cloud(res, rig_calibration["Q"])
    ref = np.asarray(jg.reproject_image_to_3d(jnp.asarray(res.disparity.numpy()),
                                              jnp.asarray(rig_calibration["Q"])))
    assert cloud.shape == (H, W, 3)
    np.testing.assert_allclose(cloud.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_batch_and_depth_range(both_results):
    pipe, res, _, (left, right) = both_results
    out = pipe.batch(np.stack([left, left]), np.stack([right, right]))
    assert out.disparity.shape == (2, H, W)
    assert torch.equal(out.disparity[1], res.disparity)
    assert torch.equal(out.depth_m[0], res.depth_m)
    assert pipe.set_depth_range(0.5, 1.0) == (0.5, 1.0)
    try:
        z = pipe(left, right).depth_m
        assert z.max().item() <= 1.0 and z[z > 0].min().item() >= 0.5
    finally:
        pipe.set_depth_range(0.1, 5.0)


def test_from_store(tmp_path, rig_calibration):
    """The reference's parameters (the LR check on) and ``mode="prod"``
    build working pipelines."""
    from stereovision_tpu_torch.pipeline import DepthPipeline
    from stereovision_tpu_torch.stereo import production_preset

    CalibrationStore(tmp_path).save("stereo_calibration_data", rig_calibration)
    pipe = DepthPipeline.from_store(tmp_path, num_disparities=32, device="cpu")
    assert pipe.size == (W, H) and pipe.params.num_disparities == 32
    assert pipe.params.mode == "full" and pipe.params.lr_max_diff == 1
    left, right = stereo_pair()
    res = pipe(left, right)
    d, c = res.disparity.numpy(), res.confidence.numpy()
    assert abs(np.median(d[20:-20, 40:-20][c[20:-20, 40:-20] > 0]) - DISP) < 0.5
    prod = DepthPipeline.from_store(tmp_path, num_disparities=64, mode="prod", device="cpu")
    assert prod.params == dataclasses.replace(production_preset(), num_disparities=64,
                                              stats_impl="pallas")


@pytest.mark.parametrize("kw", [{"proc_scale": 0.5}, {"exact_speckle": True}])
def test_unported_pipeline_options_raise(rig_calibration, kw):
    from stereovision_tpu_torch.pipeline import DepthPipeline

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        DepthPipeline(rig_calibration, _params(), device="cpu", **kw)


def test_unported_stats_autotune_and_resize_raise(both_results, rig_calibration):
    """Both are ported now: ``stats_impl="auto"`` resolves to the kernel
    form, as the reference's autotune does off the TPU, and inputs of
    another size than the calibration's are resized first, as in the
    reference's pipeline."""
    from stereovision_tpu.pipeline import DepthPipeline as JDepthPipeline
    from stereovision_tpu.stereo import SGMParams as JSGMParams
    from stereovision_tpu_torch.pipeline import DepthPipeline

    auto = DepthPipeline(rig_calibration, dataclasses.replace(_params(), stats_impl="auto"),
                         device="cpu")
    assert auto.params.stats_impl == "pallas"
    pipe = both_results[0]
    left, right = (a[::2, ::2].copy() for a in stereo_pair())
    res = pipe(left, right)
    assert res.disparity.shape == (H, W)
    jp = JSGMParams(num_disparities=32, lr_max_diff=-1, impl="xla")
    ref = JDepthPipeline(rig_calibration, jp, min_depth=0.1, max_depth=5.0)(left, right)
    np.testing.assert_array_equal(res.confidence.numpy(), np.asarray(ref.confidence))
    np.testing.assert_allclose(res.disparity.numpy(), np.asarray(ref.disparity), atol=1e-4)


def test_production_pipeline_matches_reference(rig_calibration):
    """``DepthPipeline(cal, production_preset())`` at 64 disparities against
    the reference's on the rig (192 rows: the stacked refine): disparity
    within 1e-4, confidence and depth as the reference's, all pixels valid."""
    from stereovision_tpu.pipeline import DepthPipeline as JDepthPipeline
    from stereovision_tpu.stereo import production_preset as jproduction_preset
    from stereovision_tpu_torch.pipeline import DepthPipeline

    left, right = stereo_pair(disp=30)
    jp = dataclasses.replace(jproduction_preset(), num_disparities=64, impl="xla")
    ref = JDepthPipeline(rig_calibration, jp, min_depth=0.1, max_depth=5.0)(left, right)
    res = DepthPipeline(convert.calibration_from_numpy(rig_calibration, "cpu"),
                        convert.sgm_params_from_dict(dataclasses.asdict(jp)),
                        min_depth=0.1, max_depth=5.0, device="cpu")(left, right)
    d = res.disparity.numpy()
    np.testing.assert_allclose(d, np.asarray(ref.disparity), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(res.confidence.numpy(), np.asarray(ref.confidence))
    np.testing.assert_allclose(res.depth_m.numpy(), np.asarray(ref.depth_m), rtol=1e-5)
    assert (d > -1).all()
    assert abs(np.median(d[20:-20, 40:-20]) - 30) < 0.5


def test_calibration_store_round_trip(tmp_path, rig_calibration):
    from stereovision_tpu.io.store import CalibrationStore as JStore

    CalibrationStore(tmp_path).save("cal", rig_calibration)
    mine = CalibrationStore(tmp_path).load("cal")
    ref = JStore(tmp_path).load("cal")
    assert mine.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(np.asarray(mine[key]), np.asarray(ref[key]))
    tensors = convert.calibration_from_numpy(mine, "cpu")
    assert tensors["_length_unit"] == "cm"
    assert tensors["P1"].dtype == torch.float64


# ---------------------------------------------------------------------------
# The port imports nothing of JAX
# ---------------------------------------------------------------------------

_FORBIDDEN = {"jax", "jaxlib", "stereovision_tpu"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


def test_port_imports_no_jax():
    files = sorted((REPO / "stereovision_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    # the measurement kernels and scripts are scanned with the rest
    scanned = {f.relative_to(REPO).as_posix() for f in files}
    assert {"stereovision_tpu_torch/ops/bench_cuda.py",
            "stereovision_tpu_torch/scripts/_measure.py"} | {
        f"stereovision_tpu_torch/scripts/{name}.py" for name in
        ("bench_agg_step", "bench_wta_variants", "bench_rdisp", "bench_sumwta")} <= scanned
    bad = [f"{f.relative_to(REPO)}:{line} imports {root}"
           for f in files for root, line in _imported_roots(f) if root in _FORBIDDEN]
    assert not bad, bad
    # the match is on the whole module name: the port's own name is allowed
    assert "stereovision_tpu_torch" not in _FORBIDDEN


def test_import_scan_catches_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom stereovision_tpu.core import image\nimport jax.numpy as jnp\n"
                 "from stereovision_tpu_torch import stereo\n")
    roots = [root for root, _ in _imported_roots(f)]
    assert roots == ["os", "stereovision_tpu", "jax", "stereovision_tpu_torch"]
