"""The system ``mono_depth``: ``mono.nn.estimate_depth`` of
``stereovision_tpu_torch`` with the network a configuration names, built
through ``mono.nn.create_model(arch="dpt_large", torch_state_dict=...)``
from the plain reference's seeded hub-format weights (the path a user's
hub checkpoint takes, manifest check included), on host uint8 BGR frames
as ``apps/mono_ai.py`` passes them; a frame's outputs are its normalised
depth and its confidence.

The process runs the intra-op threads that the configuration's ``host``
states and the TF32 settings its ``precision`` states. The program opens
its own spans (``mono.*``, ``dpt.*``); this module adds none.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import torch

PROGRAM = "stereovision_tpu_torch"


def _reference(config: dict):
    path = Path(__file__).resolve().parents[1] / "references" / f"{config['reference']}.py"
    spec = importlib.util.spec_from_file_location(f"mono_depth_{config['reference']}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class MonoSystem:
    def __init__(self, config: dict, device):
        from stereovision_tpu_torch.models.dpt import DPTConfig
        from stereovision_tpu_torch.mono import nn as mnn

        torch.set_num_threads(int(config["host"]["intra_op_threads"]))
        precision = config["precision"]
        if precision["dtype"] != "float32":
            raise ValueError(f"mono_depth runs float32, not {precision['dtype']}")
        torch.backends.cuda.matmul.allow_tf32 = bool(precision["allow_tf32_matmul"])
        torch.backends.cudnn.allow_tf32 = bool(precision["allow_tf32_cudnn"])
        cfg = DPTConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in config["dpt"].items()})
        self.device = torch.device(device)
        self.net_hw = tuple(config["net_hw"])
        state_dict = _reference(config).weights(config, self.device)
        self.model = mnn.create_model(arch="dpt_large", dpt_cfg=cfg, torch_state_dict=state_dict,
                                      net_hw=self.net_hw, device=self.device)
        del state_dict
        self._estimate = mnn.estimate_depth

    def call(self, frame_bgr):
        return self._estimate(self.model, frame_bgr, net_hw=self.net_hw, device=self.device)

    @staticmethod
    def outputs(result):
        return result

    def spans(self, tracer) -> None:
        """None of its own: the program's ``mono.*`` and ``dpt.*`` spans."""

    def close(self) -> None:
        self.model = None


def build(config: dict, device) -> MonoSystem:
    return MonoSystem(config, device)
