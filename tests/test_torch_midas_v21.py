"""The port's exact MiDaS v2.1 small (``models/midas_v21.py``) against the
JAX package's.

The port's ``state_dict`` has the hub checkpoint's keys, order and shapes:
those of ``expected_manifest()`` and of the vendored
``midas_v21_small_manifest.json`` (21,394,657 values). Weights cross in
both directions: seeded flax variables through
``convert.midas_v21_from_flax``, and a seeded port ``state_dict`` through
the reference's ``load_v21_state_dict``; each pair of forwards agrees at
64×64 and 96×64 within rtol 2e-4 and atol 2e-4 (the reference tests' own).
The weights are drawn into the tree ``create_v21``'s ``init`` makes
(``jax.eval_shape``), every leaf random (``tests/_hub_rig.py``): the
reference's own init takes ~30 s eagerly and leaves biases at zero and
batch norms at the identity. A ``.pt`` saved by the port loads back through
``create_model`` and ``FusedPipeline(midas_checkpoint=...)``, the latter
against the reference's pipeline at the tolerances of
``tests/test_torch_fused.py``.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import stereovision_tpu.mono.nn as jnn
from stereovision_tpu.models import midas_v21 as jv21
from stereovision_tpu.pipeline import FusedPipeline as JFused
from stereovision_tpu_torch import convert
from stereovision_tpu_torch.models import midas_v21 as tv21
from stereovision_tpu_torch.mono import nn as tnn
from stereovision_tpu_torch.pipeline import FusedPipeline

from _fused_rig import few_threads  # noqa: F401 (the module's fixture)
from _fused_rig import assert_frame_close, rig_calibration, stereo_pair
from _hub_rig import flax_template, random_flax_variables, random_state_dict, reference_hub_model

pytestmark = pytest.mark.usefixtures("few_threads")

VENDORED = (Path(__file__).resolve().parents[1] / "stereovision_tpu" / "models"
            / "midas_v21_small_manifest.json")
SHAPES = ((64, 64), (96, 64))


@pytest.fixture(scope="module")
def flax_side():
    """The reference's module, its jitted ``apply`` and seeded variables."""
    model = jv21.MidasV21Small()
    return model, jax.jit(model.apply), random_flax_variables(flax_template(model, (64, 64)), 5)


@pytest.fixture(scope="module")
def port_sd():
    """A seeded port ``state_dict`` with every entry random."""
    return random_state_dict(tv21.MidasV21Small(), 6)


def _inputs(hw, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (1, *hw, 3)).astype(np.float32)


def _forward(state_dict, x):
    model = tnn.create_model(arch="midas_v21_small", torch_state_dict=state_dict, device="cpu",
                             net_hw=x.shape[1:3])
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


def test_state_dict_is_the_hub_manifest():
    got = [(k, tuple(v.shape)) for k, v in tv21.MidasV21Small().state_dict().items()
           if not k.endswith("num_batches_tracked")]
    vendored = [(k, tuple(s)) for k, s in json.loads(VENDORED.read_text())]
    assert got == list(tv21.expected_manifest()) == vendored == jv21.expected_manifest()
    assert sum(int(np.prod(s)) for _, s in got) == 21_394_657
    assert sum(p.numel() for p in tv21.MidasV21Small().parameters()) == 21_320_545


@pytest.mark.parametrize("hw", SHAPES)
def test_flax_weights_carried_across(flax_side, hw):
    model, apply, variables = flax_side
    x = _inputs(hw)
    want = np.asarray(apply(variables, x))
    got = _forward(convert.midas_v21_from_flax(variables), x)
    assert got.shape == want.shape == (1, *hw) and want.max() > 0.1
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_port_weights_carried_to_the_reference(flax_side, port_sd):
    """The port's seeded ``state_dict`` through the reference's loader: the
    same forward, and the converter inverts the loader exactly."""
    model, apply, variables = flax_side
    loaded = jv21.load_v21_state_dict(jax.tree.map(np.zeros_like, variables), port_sd)
    x = _inputs(SHAPES[0], seed=1)
    want = np.asarray(apply(loaded, x))
    got = _forward(port_sd, x)
    assert want.max() > 0.1
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    back = convert.midas_v21_from_flax(jax.device_get(loaded))
    assert list(back) == [k for k in port_sd if not k.endswith("num_batches_tracked")]
    for key, t in back.items():
        assert torch.equal(t, port_sd[key]), key


def test_validate_names_every_difference(port_sd):
    bad = dict(port_sd)
    del bad["scratch.output_conv.4.bias"]
    bad["scratch.extra.weight"] = torch.zeros(3)
    bad["pretrained.layer1.0.weight"] = torch.zeros(32, 3, 5, 5)
    with pytest.raises(ValueError) as err:
        tv21.validate_state_dict(bad)
    msg = str(err.value)
    assert "MiDaS_small v2.1" in msg
    assert "missing keys (1): ['scratch.output_conv.4.bias']" in msg
    assert "unexpected keys (1): ['scratch.extra.weight']" in msg
    assert "shape mismatches (1): ['pretrained.layer1.0.weight: got (32, 3, 5, 5) want " \
           "(32, 3, 3, 3)']" in msg
    reordered = dict(reversed(list(port_sd.items())))
    tv21.validate_state_dict(reordered)  # the load is by name
    with pytest.raises(ValueError, match="missing keys"):
        tnn.create_model(arch="midas_v21_small", torch_state_dict={"x": torch.zeros(1)},
                         device="cpu")
    with pytest.raises(ValueError, match="multiples of 32"):
        tnn.create_model(arch="midas_v21_small", net_hw=(250, 256), device="cpu")


def test_checkpoint_file_loads_back(port_sd, tmp_path):
    """A ``.pt`` of the port's state_dict (bare, and under "state_dict", as
    the hub saves some), numpy entries too, and the seeded default."""
    path = tmp_path / "midas_v21_small.pt"
    torch.save(port_sd, path)
    torch.save({"state_dict": port_sd}, tmp_path / "wrapped.pt")
    x = torch.from_numpy(_inputs(SHAPES[0], seed=2))
    outs = []
    for source in (port_sd, path, str(tmp_path / "wrapped.pt"),
                   {k: v.numpy() for k, v in port_sd.items()
                    if not k.endswith("num_batches_tracked")}):
        model = tnn.create_model(arch="midas_v21_small", torch_state_dict=source, device="cpu")
        assert not model.training
        with torch.no_grad():
            outs.append(model(x))
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
    a, b = (tnn.create_model(arch="midas_v21_small", seed=3, device="cpu") for _ in range(2))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    with torch.no_grad():
        assert a(x).max() > 0


def test_fused_pipeline_with_the_checkpoint(port_sd, tmp_path, monkeypatch):
    """One frame of ``FusedPipeline(midas_arch="midas_v21_small",
    midas_checkpoint=...)`` with the network alone (stereo and flow off, so
    the fused frame is the network's depth) on the fused rig at scale
    0.75, against the reference's with the same checkpoint."""
    path = tmp_path / "midas_v21_small.pt"
    torch.save(port_sd, path)
    monkeypatch.setattr(jnn, "create_model", reference_hub_model)
    cal = rig_calibration()
    kw = dict(scale=0.75, use_stereo=False, use_flow=False, midas_arch="midas_v21_small",
              midas_checkpoint=str(path))
    port, ref = FusedPipeline(cal, device="cpu", **kw), JFused(cal, **kw)
    assert isinstance(port.model, tv21.MidasV21Small)
    left, right = stereo_pair(np.random.default_rng(12))
    got, want = port(left, right, t_now=0.0), ref(left, right, t_now=0.0)
    assert int(got["mode"]) == 2 and float(got["fused"].max()) > 100.0
    assert_frame_close(got, want, "midas_v21_small frame")
