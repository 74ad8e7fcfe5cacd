"""The streaming pipelines, in PyTorch: rectification + disparity + metric
depth (``DepthPipeline``), and the three-method fusion engine
(``FusedPipeline``).

Counterpart of ``stereovision_tpu/pipeline.py``: construct once from a
calibration, then call per frame pair.

    from stereovision_tpu_torch.pipeline import DepthPipeline, FusedPipeline
    pipe = DepthPipeline.from_store("output", mode="prod")
    result = pipe(left_gray, right_gray)     # DepthResult of CUDA tensors
    fused = FusedPipeline.from_store("output", scale=0.33)
    out = fused(left_gray, right_gray, t_now=timestamp)

Rectification uses the exact per-element ``remap`` (the reference's own
choice off the TPU; the separable form, ``core.image.remap_separable``, is
there for callers that want it); inputs of another size than the
processing size are resized first, as in the reference. ``stats_impl="auto"``
resolves to the statistics kernel (:func:`stereo.autotune.tune_stats_impl`).
``proc_scale`` processes the pair at a scaled size, the calibration
rescaled and rectified anew (:func:`_rescale_calibration`);
``exact_speckle`` replaces the engine's windowed speckle approximation by
the exact connected-component filter on the same device
(:func:`stereo.sgm.exact_speckle_postpass`). On a card the uint8 pair
goes up through pinned memory without a host wait and is cast to float32
there, so a call returns while the card still runs the previous frame.
Under a profile each stage of a call is a span (``depth.upload``,
``depth.rectify``, ``depth.engine``, ``depth.metric``,
``depth.exact_speckle``), and each wait of the host on the card a
``sync.*`` span (:func:`utils.profiling.annotate`).

``FusedPipeline`` runs stereo (the hierarchical engine), MidasSmall and
flow depth on the rectified pair, calibrates them against each other and
fuses them under the occlusion guard; ``stream`` runs a chunk of frames
with the guard's hysteresis on the device.
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
from stereovision_tpu_torch.utils.backend import resolve_device, upload
from stereovision_tpu_torch.utils.profiling import annotate


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

    def _upload(self, img):
        """An image as float32 on the device. On a card, an image in host
        memory goes up in its own dtype (uint8: a quarter of the float32
        bytes) through a pinned buffer the program owns, without a host
        wait, and is cast on the card (:func:`utils.backend.upload`); the
        caller may reuse its own buffer, pinned or not, as soon as the call
        returns. On the CPU the image is cast where it is."""
        if self.device.type != "cuda":
            return torch.as_tensor(img, dtype=torch.float32, device=self.device)
        return upload(img, self.device).to(torch.float32)

    def _run(self, left, right):
        h, w = self.proc_size[1], self.proc_size[0]
        with annotate("depth.upload"):
            left = self._upload(left)
            right = self._upload(right)
        with annotate("depth.rectify"):
            if left.shape != (h, w):
                left = im.resize(left, (h, w))
                right = im.resize(right, (h, w))
            mx1, my1, mx2, my2 = self._maps
            lr = im.remap(left, mx1, my1)
            rr = im.remap(right, mx2, my2)
        with annotate("depth.engine"):
            disp, conf = disparity_with_confidence(lr, rr, self.params, self.device)
        with annotate("depth.metric"):
            depth = geom.disparity_to_depth(disp, self.focal, self.baseline_m)
            depth = depth.clamp(self.min_depth, self.max_depth)
            depth = torch.where(conf > 0, depth, 0.0)
        return disp, conf, depth

    def __call__(self, left, right) -> DepthResult:
        disp, conf, depth = self._run(left, right)
        if self._exact_speckle:
            with annotate("depth.exact_speckle"):
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


class FusedPipeline:
    """The three-method fusion engine (stereo + neural + motion depth, with
    the occlusion fallback) as a stateful streaming object on ``device``;
    the embeddable form of ``apps.fused``.

    Each frame: resize to the processing size, rectify (the exact remap),
    the occlusion scores, stereo (``SGMParams(mode="hier",
    coarse_scale=2, refine_range=32, paths=2)`` at D = max(16,
    ⌊320·scale⌋ rounded down to a multiple of 16)), the mono-depth network
    on the rectified left image (``mono.nn.create_model(midas_arch,
    torch_state_dict=midas_checkpoint)``: MidasSmall with the bundled
    weights by default, or the exact MiDaS v2.1 small or DPT-Large with a
    hub checkpoint), flow depth, the range calibrations, the fusion
    and meters. The per-frame form reads a frame's occlusion scores on the
    next frame (copied to pinned host memory behind an event, so the
    steady-state loop does not wait for the card); the 5-frame hysteresis
    tolerates the lag. Outputs are tensors on ``device``: reading ``mode``
    or ``camera_moving`` waits for the frame, so consumers read them only
    where they display or store them."""

    def __init__(self, cal: dict, scale: float = 0.33, use_stereo=True, use_midas=True,
                 use_flow=True, fusion_params=None, midas_arch: str = "small",
                 midas_checkpoint=None, device="cuda"):
        from stereovision_tpu_torch.fusion import FusionParams, OcclusionHysteresis
        from stereovision_tpu_torch.mono import FlowDepthParams, flow_depth_init
        from stereovision_tpu_torch.mono.nn import create_model

        self.device = resolve_device(device)
        self.proc, self.cal = _rescale_calibration(cal, scale)
        num_disp = max(16, int(320 * scale) // 16 * 16)
        self.sgm = SGMParams(num_disparities=num_disp, mode="hier", coarse_scale=2,
                             refine_range=32, paths=2)
        self.depth_pipe = DepthPipeline(self.cal, self.sgm, device=self.device)
        self.fusion_params = fusion_params or FusionParams()
        self.hysteresis = OcclusionHysteresis()
        self.use_stereo = use_stereo
        self.use_midas = use_midas
        self.use_flow = use_flow
        self.model = (create_model(arch=midas_arch, torch_state_dict=midas_checkpoint,
                                   device=self.device) if use_midas else None)
        self.flow_state = (flow_depth_init((self.proc[1], self.proc[0]), device=self.device)
                           if use_flow else None)
        self.flow_params = FlowDepthParams()
        self._frame = 0
        self._pending_scores = None  # (host copy of the two scores, its event)

    @classmethod
    def from_store(cls, calib_dir, **kw):
        from stereovision_tpu_torch.io.store import CalibrationStore

        cal = CalibrationStore(calib_dir).load("stereo_calibration_data")
        return cls(cal, **kw)

    def set_params(self, **kw):
        """Live-tune any ``FusionParams`` field."""
        self.fusion_params = dataclasses.replace(self.fusion_params, **kw)
        return self.fusion_params

    def _rectify(self, left, right):
        h, w = self.proc[1], self.proc[0]
        mx1, my1, mx2, my2 = self.depth_pipe._maps
        lr = im.remap(im.resize(left.to(torch.float32), (h, w)), mx1, my1)
        rr = im.remap(im.resize(right.to(torch.float32), (h, w)), mx2, my2)
        return lr, rr

    def _stereo(self, lr, rr):
        disp, conf = disparity_with_confidence(lr, rr, self.sgm, self.device)
        return (disp / self.sgm.num_disparities * 255.0).clamp(0, 255), conf

    def _meters(self, fused):
        from stereovision_tpu_torch.fusion import fused_to_meters

        return fused_to_meters(fused, self.depth_pipe.focal, self.depth_pipe.baseline_m * 100.0,
                               num_disparities=float(self.sgm.num_disparities),
                               device=self.device)

    def _step(self, left, right, t_now: float, stereo_on: bool, flow_src_right: bool):
        """One frame: (out or None, the occlusion scores)."""
        from stereovision_tpu_torch.fusion import (calibrate_midas_to_stereo, fuse_depth_maps,
                                                   normalize_to_stereo_range, occlusion_scores)
        from stereovision_tpu_torch.mono import flow_depth_step
        from stereovision_tpu_torch.mono.nn import estimate_depth

        dev = self.device
        lr, rr = self._rectify(left, right)
        scores = occlusion_scores(lr, rr, device=dev)
        stereo_norm = stereo_conf = None
        if stereo_on:
            stereo_norm, stereo_conf = self._stereo(lr, rr)
        midas_cal = midas_conf = None
        if self.use_midas:
            md, midas_conf = estimate_depth(self.model, torch.stack([lr] * 3, dim=-1), device=dev)
            midas_cal = (calibrate_midas_to_stereo(md, stereo_norm, stereo_conf, device=dev)
                         if stereo_norm is not None else md)
        flow_norm = None
        moving = torch.zeros((), dtype=torch.bool, device=dev)
        if self.flow_state is not None:
            self.flow_state, fd, has, mv = flow_depth_step(
                self.flow_state, rr if flow_src_right else lr, t_now, self.flow_params, device=dev)
            ref = stereo_norm if stereo_norm is not None else fd
            flow_norm = normalize_to_stereo_range(fd, ref, device=dev)
            moving = mv & has
        have = (stereo_norm is not None, midas_cal is not None, flow_norm is not None)
        if not any(have):
            return None, scores
        fused, conf, mode = fuse_depth_maps(
            stereo_norm, stereo_conf, midas_cal, midas_conf, flow_norm, moving,
            self.fusion_params, have_stereo=have[0], have_midas=have[1], have_flow=have[2],
            device=dev)
        return {"fused": fused, "confidence": conf, "meters": self._meters(fused),
                "mode": mode, "camera_moving": moving}, scores

    def _keep_scores(self, scores):
        """Start the copy of a frame's two scores to the host; the next frame
        reads them (:meth:`_read_scores`)."""
        both = torch.stack(scores)
        if both.is_cuda:
            host = torch.empty(2, dtype=both.dtype, pin_memory=True)
            host.copy_(both, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            self._pending_scores = (host, event)
        else:
            self._pending_scores = (both, None)

    def _read_scores(self):
        host, event = self._pending_scores
        if event is not None:
            with annotate("sync.occlusion_scores"):
                event.synchronize()  # the copy left the card a frame ago
        return float(host[0]), float(host[1])

    def __call__(self, left, right, t_now: float):
        from stereovision_tpu_torch.fusion import classify_occlusion

        if self._frame % 2 == 0 and self._pending_scores is not None:
            # the previous frame's scores: the occlusion check runs every
            # second frame, one frame late
            self.hysteresis.update(classify_occlusion(*self._read_scores()))
        state = self.hysteresis.state
        self._frame += 1
        out, scores = self._step(
            upload(left, self.device), upload(right, self.device),
            float(np.float32(t_now)), stereo_on=self.use_stereo and self.hysteresis.stereo_enabled,
            flow_src_right=state == "left")
        if self._frame % 2 == 1:  # this frame's scores, read on the next
            self._keep_scores(scores)
        if out is None:
            return None
        out["occlusion"] = state
        return out

    def stream(self, lefts, rights, t0: float = 0.0, dt: float = 1.0 / 30.0):
        """Throughput form: a chunk of frames, uploaded at once (pass uint8
        stacks: the cast to float32 happens on the device), with the
        occlusion hysteresis run on the device as int32 tensors
        (``fusion.hysteresis_update`` every frame). Stereo runs every frame;
        whether it takes part is a ``torch.where`` on the hysteresis state,
        as is the flow's source image (the right one while the left camera
        is occluded). Returns a dict of frame-stacked outputs; the flow
        state and the hysteresis carry across chunks (one 3-integer
        read-back a chunk)."""
        from stereovision_tpu_torch.fusion import (
            OCCLUSION_CODES, calibrate_midas_to_stereo, classify_occlusion_code,
            fuse_depth_maps, hysteresis_update, normalize_to_stereo_range, occlusion_scores)
        from stereovision_tpu_torch.mono import flow_depth_step
        from stereovision_tpu_torch.mono.nn import estimate_depth

        dev = self.device
        lefts, rights = upload(lefts, dev), upload(rights, dev)
        n = lefts.shape[0]
        ts = (t0 + dt * np.arange(n, dtype=np.float32)).astype(np.float32)
        hy = self.hysteresis
        hyst = tuple(torch.full((), v, dtype=torch.int32, device=dev) for v in (
            OCCLUSION_CODES.index(hy.state), OCCLUSION_CODES.index(hy._pending), hy._count))
        use_midas, use_flow = self.use_midas, self.flow_state is not None
        p = self.fusion_params
        h, w = self.proc[1], self.proc[0]
        frames = []
        for k in range(n):
            lr, rr = self._rectify(lefts[k], rights[k])
            ls, rs = occlusion_scores(lr, rr, device=dev)
            hyst = hysteresis_update(hyst, classify_occlusion_code(ls, rs, device=dev))
            state = hyst[0]
            stereo_norm, sconf = self._stereo(lr, rr)
            md = midas_conf = fd = None
            if use_midas:
                md, midas_conf = estimate_depth(self.model, torch.stack([lr] * 3, dim=-1),
                                                device=dev)
            moving = torch.zeros((), dtype=torch.bool, device=dev)
            if use_flow:
                src = torch.where(state == 1, rr, lr)  # left occluded → flow on the right
                self.flow_state, fd, has, mv = flow_depth_step(
                    self.flow_state, src, float(ts[k]), self.flow_params, device=dev)
                moving = mv & has
            with_stereo = fuse_depth_maps(
                stereo_norm, sconf,
                calibrate_midas_to_stereo(md, stereo_norm, sconf, device=dev) if use_midas else None,
                midas_conf,
                normalize_to_stereo_range(fd, stereo_norm, device=dev) if use_flow else None,
                moving, p, have_stereo=True, have_midas=use_midas, have_flow=use_flow, device=dev)
            if use_midas or use_flow:
                ref = md if use_midas else fd
                without = fuse_depth_maps(
                    None, None, md, midas_conf,
                    normalize_to_stereo_range(fd, ref, device=dev) if use_flow else None,
                    moving, p, have_stereo=False, have_midas=use_midas, have_flow=use_flow,
                    device=dev)
            else:
                z = torch.zeros((h, w), dtype=torch.float32, device=dev)
                without = (z, z, torch.zeros((), dtype=torch.int32, device=dev))
            on = state == 0
            fused, conf, mode = (torch.where(on, a, b) for a, b in zip(with_stereo, without))
            frames.append({"fused": fused, "confidence": conf, "meters": self._meters(fused),
                           "mode": mode, "occlusion_code": state, "camera_moving": moving})
        outs = {key: torch.stack([f[key] for f in frames]) for key in frames[0]}
        self._frame += n
        with annotate("sync.hysteresis"):
            st, pend, cnt = torch.stack(hyst).tolist()
        hy.state, hy._pending, hy._count = OCCLUSION_CODES[st], OCCLUSION_CODES[pend], cnt
        return outs
