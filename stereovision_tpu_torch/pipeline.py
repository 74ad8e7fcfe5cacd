"""Rectification + disparity + metric depth, in PyTorch.

Counterpart of ``stereovision_tpu/pipeline.py``'s ``DepthPipeline``:
construct once from a calibration, then call per frame pair.

    from stereovision_tpu_torch.pipeline import DepthPipeline
    pipe = DepthPipeline.from_store("output", mode="prod")
    result = pipe(left_gray, right_gray)     # DepthResult of CUDA tensors

Rectification uses the exact per-element ``remap`` (the reference's own
choice off the TPU; the separable form, ``core.image.remap_separable``, is
there for callers that want it); inputs of another size than the
processing size are resized first, as in the reference. ``stats_impl="auto"``
resolves to the statistics kernel (:func:`stereo.autotune.tune_stats_impl`).
``proc_scale`` processes the pair at a scaled size, the calibration
rescaled and rectified anew (:func:`_rescale_calibration`);
``exact_speckle`` replaces the engine's windowed speckle approximation by
the exact connected-component filter on the same device
(:func:`stereo.sgm.exact_speckle_postpass`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stereovision_tpu_torch.core import geometry as geom
from stereovision_tpu_torch.core import image as im
from stereovision_tpu_torch.stereo import SGMParams, disparity_with_confidence
from stereovision_tpu_torch.stereo.autotune import tune_stats_impl
from stereovision_tpu_torch.stereo.sgm import check_params, exact_speckle_postpass
from stereovision_tpu_torch.utils.backend import resolve_device


@dataclasses.dataclass
class DepthResult:
    disparity: torch.Tensor   # (H, W) float px
    confidence: torch.Tensor  # (H, W) 0/1 (reference contract)
    depth_m: torch.Tensor     # (H, W) meters, 0 where invalid


class DepthPipeline:
    """Rectification + disparity + metric depth on ``device``."""

    def __init__(self, cal: dict, params: SGMParams, min_depth=0.2, max_depth=4.0,
                 proc_scale: float = 1.0, exact_speckle: bool = False, device="cuda"):
        # exact_speckle: the engine runs without its speckle stage, and the
        # exact filter runs on its result with the caller's window and range
        self._exact_speckle = exact_speckle and params.speckle_window_size > 0
        self._speckle_params = params
        if self._exact_speckle:
            params = dataclasses.replace(params, speckle_window_size=0)
        params = check_params(tune_stats_impl(params))
        self.device = resolve_device(device)
        self.size = tuple(int(v) for v in np.asarray(torch.as_tensor(cal["img_size"]).cpu()))
        self.proc_size = self.size
        if proc_scale != 1.0:
            self.proc_size, cal = _rescale_calibration(cal, proc_scale)

        def f64(key):
            return torch.as_tensor(cal[key], dtype=torch.float64, device=self.device)

        mx1, my1 = geom.init_undistort_rectify_map(
            f64("mtx_left"), f64("dist_left").ravel(), f64("R1"), f64("P1"), self.proc_size)
        mx2, my2 = geom.init_undistort_rectify_map(
            f64("mtx_right"), f64("dist_right").ravel(), f64("R2"), f64("P2"), self.proc_size)
        self._maps = (mx1, my1, mx2, my2)
        self.focal = float(f64("P1")[0, 0])
        self.baseline_m = abs(float(f64("T").ravel()[0])) / 100.0
        self.params = params
        self.min_depth = min_depth
        self.max_depth = max_depth

    @classmethod
    def from_store(cls, calib_dir, num_disparities=320, mode="full", refine_range=32, **kw):
        """Pipeline from a ``CalibrationStore`` directory, with the reference's
        parameters: ``SGMParams(num_disparities, mode, refine_range)``, or
        with ``mode="prod"`` the production preset at ``num_disparities``."""
        from stereovision_tpu_torch.io.store import CalibrationStore

        cal = CalibrationStore(calib_dir).load("stereo_calibration_data")
        if mode == "prod":
            from stereovision_tpu_torch.stereo import production_preset

            params = dataclasses.replace(production_preset(), num_disparities=num_disparities)
        else:
            params = SGMParams(num_disparities=num_disparities, mode=mode,
                               refine_range=refine_range)
        return cls(cal, params, **kw)

    def _run(self, left, right):
        h, w = self.proc_size[1], self.proc_size[0]
        left = torch.as_tensor(left, dtype=torch.float32, device=self.device)
        right = torch.as_tensor(right, dtype=torch.float32, device=self.device)
        if left.shape != (h, w):
            left = im.resize(left, (h, w))
            right = im.resize(right, (h, w))
        mx1, my1, mx2, my2 = self._maps
        lr = im.remap(left, mx1, my1)
        rr = im.remap(right, mx2, my2)
        disp, conf = disparity_with_confidence(lr, rr, self.params, self.device)
        depth = geom.disparity_to_depth(disp, self.focal, self.baseline_m)
        depth = depth.clamp(self.min_depth, self.max_depth)
        depth = torch.where(conf > 0, depth, 0.0)
        return disp, conf, depth

    def __call__(self, left, right) -> DepthResult:
        disp, conf, depth = self._run(left, right)
        if self._exact_speckle:
            disp, valid = exact_speckle_postpass(disp, self._speckle_params)
            conf = torch.where(valid, conf, 0.0)
            depth = torch.where(valid, depth, 0.0)
        return DepthResult(disp, conf, depth)

    def batch(self, lefts, rights) -> DepthResult:
        """(B, H, W) stacks → DepthResult with a leading frame axis; frames
        run one after another through :meth:`__call__`, so one frame's
        volumes are live at a time (and ``exact_speckle`` filters each
        frame, which the reference's batch form skips)."""
        outs = [self(l, r) for l, r in zip(lefts, rights)]
        return DepthResult(*(torch.stack([getattr(o, f.name) for o in outs])
                             for f in dataclasses.fields(DepthResult)))

    def set_depth_range(self, min_depth=None, max_depth=None):
        """Live-tune the metric clip window."""
        if min_depth is not None:
            self.min_depth = float(min_depth)
        if max_depth is not None:
            self.max_depth = float(max_depth)
        return self.min_depth, self.max_depth

    def point_cloud(self, result: DepthResult, Q) -> torch.Tensor:
        return geom.reproject_image_to_3d(
            result.disparity, torch.as_tensor(Q, dtype=torch.float32, device=self.device))


def _rescale_calibration(cal: dict, scale: float):
    """The calibration at the processing size: K scaled to the size
    (max(32, ⌊size·scale⌋) rounded down to even, per axis) and the pair
    rectified anew there (:func:`core.geometry.stereo_rectify`, alpha 0),
    in float64 on the host, as the reference's ``_rescale_calibration``.
    Returns (processing size (w, h), the rescaled calibration as numpy)."""
    def host(key):
        return np.asarray(torch.as_tensor(cal[key]).cpu(), np.float64)

    size = tuple(int(v) for v in host("img_size"))
    proc = (max(32, int(size[0] * scale)) // 2 * 2, max(32, int(size[1] * scale)) // 2 * 2)
    K1, K2 = host("mtx_left").copy(), host("mtx_right").copy()
    for K in (K1, K2):
        K[0] *= proc[0] / size[0]
        K[1] *= proc[1] / size[1]
    R1, R2, P1, P2, Q = geom.stereo_rectify(
        torch.from_numpy(K1), torch.from_numpy(host("dist_left").ravel()),
        torch.from_numpy(K2), torch.from_numpy(host("dist_right").ravel()),
        proc, torch.from_numpy(host("R")), torch.from_numpy(host("T").ravel()), alpha=0.0)
    out = dict(cal)
    out.update(mtx_left=K1, mtx_right=K2, R1=R1.numpy(), R2=R2.numpy(), P1=P1.numpy(),
               P2=P2.numpy(), Q=Q.numpy(), img_size=np.asarray(proc))
    return proc, out
