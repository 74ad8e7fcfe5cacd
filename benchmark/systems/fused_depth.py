"""The system ``fused_depth``: ``FusedPipeline.__call__`` of
``stereovision_tpu_torch``, built from a fused configuration as
``apps/fused.py`` builds it (``FusedPipeline(cal, scale=...)``), with the
network the configuration names (MiDaS v2.1 small) loaded through
``mono.nn.create_model``'s hub-checkpoint path from the plain reference's
seeded hub-format weights, on host uint8 pairs; the k-th call is stamped
``t_now = k / camera_fps`` (a camera's clock, so the state does not depend
on the host's speed). A frame's outputs are its fused map, confidence,
metres, mode code and whether the camera moves.

The pipeline carries state from frame to frame, so the module offers
``snapshot()`` (``harness.py``): copies on the device of everything the
next call reads from earlier calls, taken without a host wait.

The process runs the intra-op threads that the configuration's ``host``
states and the TF32 settings its ``precision`` states. The program opens
its own spans (``sgm.*``, ``mono.*``, ``sync.*``); this module adds none.
Building raises where the pipeline's settings are not those that the
configuration writes out.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import inspect
from pathlib import Path

import torch

from benchmark.depth_config import calibration

PROGRAM = "stereovision_tpu_torch"


def _reference(config: dict):
    path = Path(__file__).resolve().parents[1] / "references" / f"{config['reference']}.py"
    spec = importlib.util.spec_from_file_location(f"fused_depth_{config['reference']}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class FusedSystem:
    def __init__(self, config: dict, device):
        from stereovision_tpu_torch.fusion import FusionParams
        from stereovision_tpu_torch.mono import FlowDepthParams
        from stereovision_tpu_torch.pipeline import FusedPipeline
        from stereovision_tpu_torch.stereo import SGMParams

        torch.set_num_threads(int(config["host"]["intra_op_threads"]))
        precision = config["precision"]
        if precision["dtype"] != "float32":
            raise ValueError(f"fused_depth runs float32, not {precision['dtype']}")
        torch.backends.cuda.matmul.allow_tf32 = bool(precision["allow_tf32_matmul"])
        torch.backends.cudnn.allow_tf32 = bool(precision["allow_tf32_cudnn"])
        f = config["fused"]
        state_dict = _reference(config).weights(config, device) if f["use_midas"] else None
        self.pipe = FusedPipeline(calibration(config), scale=f["scale"],
                                  use_stereo=f["use_stereo"], use_midas=f["use_midas"],
                                  use_flow=f["use_flow"],
                                  fusion_params=FusionParams(**config["fusion"]),
                                  midas_arch=f["midas_arch"], midas_checkpoint=state_dict,
                                  device=device)
        del state_dict
        stated = {"sgm": SGMParams(**config["sgm"]), "flow": FlowDepthParams(**config["flow"])}
        running = {"sgm": self.pipe.sgm, "flow": self.pipe.flow_params}
        for key, want in stated.items():
            if running[key] != want:
                raise ValueError(f"the pipeline runs {key} {running[key]}, the configuration "
                                 f"states {want}")
        from stereovision_tpu_torch.mono.nn import estimate_depth

        net_hw = inspect.signature(estimate_depth).parameters["net_hw"].default
        if list(net_hw) != list(f["net_hw"]):
            raise ValueError(f"the pipeline's network reads {net_hw}, the configuration "
                             f"states {f['net_hw']}")
        if list(self.pipe.proc) != list(f["processing_size"]):
            raise ValueError(f"the pipeline processes at {self.pipe.proc}, the configuration "
                             f"states {f['processing_size']}")
        self.fps = float(config["camera_fps"])
        self.device = torch.device(device)
        self.k = 0

    def call(self, left, right):
        t_now = self.k / self.fps
        self.k += 1
        return self.pipe(left, right, t_now=t_now)

    @staticmethod
    def outputs(result):
        return (result["fused"], result["confidence"], result["meters"], result["mode"],
                result["camera_moving"])

    def snapshot(self) -> dict:
        """The state the next call reads: the flow state's tensors (cloned)
        and its generator's state (``get_state``, the host's record of the
        seed and offset), the hysteresis, the pending occlusion scores (the
        pinned host copy of the last odd frame's two scores, copied back up
        behind the copy that fills it, so read in stream order), the
        frame counter and the clock's count."""
        p, fs = self.pipe, self.pipe.flow_state
        scores = None
        if p._pending_scores is not None:
            scores = p._pending_scores[0].to(self.device, non_blocking=True, copy=True)
        hy = p.hysteresis
        out = {"hysteresis": (hy.state, hy._pending, hy._count), "pending_scores": scores,
               "frame": p._frame, "clock": self.k}
        if fs is not None:
            out.update({f.name: getattr(fs, f.name).clone()
                        for f in dataclasses.fields(fs) if f.name != "rng"})
            out["rng_state"] = fs.rng.get_state()
        return out

    def spans(self, tracer) -> None:
        """None of its own: the program's ``sgm.*``, ``mono.*`` and
        ``sync.*`` spans."""

    def close(self) -> None:
        self.pipe = None


def build(config: dict, device) -> FusedSystem:
    return FusedSystem(config, device)
