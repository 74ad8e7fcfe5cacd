"""The system ``depth_pipeline``: ``DepthPipeline.__call__`` of
``stereovision_tpu_torch``, built from a depth configuration, on host
uint8 pairs as ``apps/depth.py`` passes them; a frame's outputs are its
disparity, confidence and depth.

A system module is named by a configuration's ``system`` and found as
``systems/<name>.py``. It names the package it drives (``PROGRAM``), and
its ``build(config, device)`` returns an object with ``call`` (the timed
entry), ``outputs(result)`` (the tensors that have to reach the host),
``spans(tracer)`` (the spans of its layers, for a traced run) and
``close()``. The program's CUDA libraries build on their first use, into
the checkout's ``build/cuda/``. The process runs the intra-op threads
that the configuration's ``host`` states.
"""

from __future__ import annotations

import torch

from benchmark.depth_config import calibration

PROGRAM = "stereovision_tpu_torch"


class DepthSystem:
    def __init__(self, config: dict, device):
        from stereovision_tpu_torch import pipeline
        from stereovision_tpu_torch.stereo import SGMParams

        torch.set_num_threads(int(config["host"]["intra_op_threads"]))
        spec = config["pipeline"]
        self._module = pipeline
        self._engine = pipeline.disparity_with_confidence
        self.call = pipeline.DepthPipeline(calibration(config), SGMParams(**spec["params"]),
                                           min_depth=spec["min_depth"],
                                           max_depth=spec["max_depth"], device=device)

    @staticmethod
    def outputs(result):
        return result.disparity, result.confidence, result.depth_m

    def spans(self, tracer) -> None:
        """An ``engine`` span around the pipeline's call into the stereo
        engine (``stereo.sgm.disparity_with_confidence``)."""
        inner = self._engine

        def engine(*args, **kw):
            with tracer.span("engine"):
                return inner(*args, **kw)

        self._module.disparity_with_confidence = engine

    def close(self) -> None:
        self._module.disparity_with_confidence = self._engine
        self.call = None


def build(config: dict, device) -> DepthSystem:
    return DepthSystem(config, device)
