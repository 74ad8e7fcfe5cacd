"""The port's exact DPT (``models/dpt.py``) against the JAX package's.

The full ``DPT_LARGE`` module built on the ``meta`` device (no weight
memory) has the vendored ``dpt_large_manifest.json``'s keys, order and
shapes (344,055,465 values); ``DPT_TINY`` has the reference's computed
manifest. With ``DPT_TINY`` weights cross in both directions (seeded flax
variables through ``convert.dpt_from_flax``; a seeded port ``state_dict``
through the reference's ``load_dpt_state_dict``) and the forwards agree
within rtol 2e-4 and atol 2e-4 at 64×64 (the native 4×4 grid), 96×64 (an
upsampled 6×4 grid) and 32×32 (a 2×2 grid from the native 4×4: the
reference resizes the position embedding with antialiasing, which a
plain bilinear resize does not match). A ``.pt`` saved by the port loads
back through ``create_model(arch="dpt_large", dpt_cfg=DPT_TINY)``. No
full-size forward runs here.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stereovision_tpu.models import dpt as jdpt
from stereovision_tpu_torch import convert
from stereovision_tpu_torch.models import dpt as tdpt
from stereovision_tpu_torch.mono import nn as tnn

from _fused_rig import few_threads  # noqa: F401 (the module's fixture)
from _hub_rig import flax_template, random_flax_variables, random_state_dict

pytestmark = pytest.mark.usefixtures("few_threads")

VENDORED = (Path(__file__).resolve().parents[1] / "stereovision_tpu" / "models"
            / "dpt_large_manifest.json")
CFG = tdpt.DPT_TINY
# native grid, an upsampled one, a downsampled one
SHAPES = ((64, 64), (96, 64), (32, 32))


@pytest.fixture(scope="module")
def flax_side():
    model = jdpt.DPTDepth(jdpt.DPT_TINY)
    return model, jax.jit(model.apply), random_flax_variables(flax_template(model, (64, 64)), 7)


@pytest.fixture(scope="module")
def port_sd():
    return random_state_dict(tdpt.DPTDepth(CFG), 8)


def _inputs(hw, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (1, *hw, 3)).astype(np.float32)


def _port(state_dict):
    return tnn.create_model(arch="dpt_large", dpt_cfg=CFG, torch_state_dict=state_dict,
                            net_hw=(64, 64), device="cpu")


def _forward(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


def test_full_size_state_dict_is_the_hub_manifest():
    with torch.device("meta"):
        model = tdpt.DPTDepth(tdpt.DPT_LARGE)
    got = [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
    vendored = [(k, tuple(s)) for k, s in json.loads(VENDORED.read_text())]
    assert got == list(tdpt.expected_manifest()) == vendored
    n = sum(int(np.prod(s)) for _, s in got)
    assert n == 344_055_465 and 330e6 < n < 360e6
    tiny = [(k, tuple(v.shape)) for k, v in tdpt.DPTDepth(CFG).state_dict().items()]
    assert tiny == list(tdpt.expected_manifest(CFG)) == jdpt.expected_manifest(jdpt.DPT_TINY)
    assert tdpt.DPT_LARGE == tdpt.DPTConfig(**vars(jdpt.DPT_LARGE))
    assert CFG == tdpt.DPTConfig(**vars(jdpt.DPT_TINY))


@pytest.mark.parametrize("hw", SHAPES)
def test_flax_weights_carried_across(flax_side, hw):
    model, apply, variables = flax_side
    x = _inputs(hw)
    want = np.asarray(apply(variables, x))
    got = _forward(_port(convert.dpt_from_flax(variables, CFG)), x)
    assert got.shape == want.shape == (1, *hw) and want.max() > 0.1
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_downsampled_grid_needs_the_antialiased_resize(flax_side, monkeypatch):
    """The 2×2 grid from the native 4×4 without antialiasing (the hub's
    own ``_resize_pos_embed``) misses the reference by more than ten times
    the tolerance."""
    model, apply, variables = flax_side
    x = _inputs(SHAPES[2])
    want = np.asarray(apply(variables, x))
    port = _port(convert.dpt_from_flax(variables, CFG))

    def plain(pos_embed, grid_hw, native_grid):
        C = pos_embed.shape[-1]
        grid = pos_embed[:, 1:].reshape(1, native_grid, native_grid, C).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, size=grid_hw, mode="bilinear", align_corners=False)
        return torch.cat([pos_embed[:, :1], grid.permute(0, 2, 3, 1).reshape(1, -1, C)], dim=1)

    monkeypatch.setattr(tdpt, "resize_pos_embed", plain)
    assert np.abs(_forward(port, x) - want).max() > 10 * (2e-4 + 2e-4 * np.abs(want).max())


def test_port_weights_carried_to_the_reference(flax_side, port_sd):
    model, apply, variables = flax_side
    loaded = jdpt.load_dpt_state_dict(jax.tree.map(np.zeros_like, variables), port_sd,
                                      jdpt.DPT_TINY)
    x = _inputs(SHAPES[0], seed=1)
    want = np.asarray(apply(loaded, x))
    assert want.max() > 0.1
    np.testing.assert_allclose(_forward(_port(port_sd), x), want, rtol=2e-4, atol=2e-4)
    back = convert.dpt_from_flax(jax.device_get(loaded), CFG)
    assert list(back) == list(port_sd)
    for key, t in back.items():
        assert torch.equal(t, port_sd[key]), key


def test_validate_names_every_difference(port_sd):
    bad = dict(port_sd)
    del bad["scratch.output_conv.4.bias"]
    bad["pretrained.model.extra"] = torch.zeros(1)
    bad["pretrained.model.pos_embed"] = torch.zeros(1, 5, 32)
    with pytest.raises(ValueError) as err:
        tdpt.validate_state_dict(bad, CFG)
    msg = str(err.value)
    assert "missing keys (1): ['scratch.output_conv.4.bias']" in msg
    assert "unexpected keys (1): ['pretrained.model.extra']" in msg
    assert "shape mismatches (1): ['pretrained.model.pos_embed: got (1, 5, 32) want " \
           "(1, 17, 32)']" in msg
    with pytest.raises(ValueError, match="DPT_Large: missing keys"):
        tnn.create_model(arch="dpt_large", torch_state_dict=port_sd, device="cpu")  # DPT_LARGE


def test_create_model_dpt(port_sd, tmp_path):
    """``create_model(arch="dpt_large", dpt_cfg=DPT_TINY)``: seeded, from a
    ``.pt``, through ``estimate_depth``; sizes it cannot take raise."""
    model = tnn.create_model(arch="dpt_large", dpt_cfg=CFG, net_hw=(64, 64), device="cpu")
    assert isinstance(model, tdpt.DPTDepth) and not model.training
    x = _inputs((64, 64), seed=3)
    assert _forward(model, x).shape == (1, 64, 64) and _forward(model, x).max() > 0
    path = tmp_path / "dpt_tiny.pt"
    torch.save(port_sd, path)
    assert np.array_equal(_forward(_port(path), x), _forward(_port(port_sd), x))
    frame = np.random.default_rng(4).uniform(0, 255, (40, 56, 3)).astype(np.float32)
    depth, conf = tnn.estimate_depth(_port(path), frame, net_hw=(64, 64), device="cpu")
    assert depth.shape == conf.shape == (40, 56) and abs(float(depth.max()) - 255.0) < 1e-3
    with pytest.raises(ValueError, match="multiples of 32"):
        tnn.create_model(arch="dpt_large", dpt_cfg=CFG, net_hw=(48, 64), device="cpu")
    with pytest.raises(ValueError, match="multiples of 32"):
        model(torch.zeros(1, 48, 64, 3))
