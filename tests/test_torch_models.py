"""The port's ``models`` (the msgpack reader, MidasSmall) and ``mono.nn``
against the JAX package's.

The reader equals ``flax.serialization.msgpack_restore`` leaf for leaf on
the bundled ``midas_synthetic.msgpack`` (dtype, shape and bytes), and
round-trips structures that ``msgpack.packb`` packs with flax's extension
hook. ``MidasSmall`` with the bundled weights, carried across by
``convert.midas_small_from_flax``, equals the flax ``apply`` at 256×256
within rtol 1e-4 of the output's range (XLA's and PyTorch's convolutions
accumulate in other orders); ``estimate_depth`` at 236×422 within 0.05 on
the 0-255 scale for depth and 1e-5 for the confidence.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from stereovision_tpu.mono import nn as jnn
from stereovision_tpu_torch import convert
from stereovision_tpu_torch.models import checkpoint
from stereovision_tpu_torch.models.midas import MidasSmall
from stereovision_tpu_torch.mono import nn as tnn

BUNDLED = (Path(__file__).resolve().parents[1] / "stereovision_tpu" / "models" / "pretrained"
           / "midas_synthetic.msgpack")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.fixture(scope="module")
def reference():
    """The reference's model and its bundled variables, and one forward."""
    model, variables = jnn.create_model(net_hw=(256, 256))
    return model, variables


def test_reader_equals_flax_on_the_bundled_file():
    raw = BUNDLED.read_bytes()
    assert len(raw) == 7_374_201 and tnn.PRETRAINED == BUNDLED
    mine = dict(_leaves(checkpoint.load_variables(BUNDLED)))
    ref = dict(_leaves(serialization.msgpack_restore(raw)))
    assert list(mine) == list(ref) and len(mine) == 200
    assert {p[0] for p in mine} == {"params", "batch_stats"}
    for path, arr in mine.items():
        want = ref[path]
        assert arr.dtype == want.dtype and arr.shape == want.shape, path
        assert arr.tobytes() == want.tobytes(), path


def _packed(obj):
    return msgpack.packb(obj, default=serialization._msgpack_ext_pack, use_bin_type=True)


def _same(a, b):
    if isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b)
        for k in b:
            _same(a[k], b[k])
    elif isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (a, b)


def test_reader_round_trips_flax_packed_structures():
    rng = np.random.default_rng(0)
    obj = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63 - 1,
                 -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63],
        "floats": [0.0, -1.5, 1e300, float("inf"), float("nan"), 3.25],
        "misc": [None, True, False, b"", b"\x00\x01" * 40, b"x" * 70000, complex(1.5, -2.0)],
        "strings": ["", "a", "é" * 20, "s" * 40, "t" * 300, "u" * 70000],
        "arrays": {
            "f32": rng.normal(size=(3, 4)).astype(np.float32),
            "f64": rng.normal(size=(5,)),
            "i8": rng.integers(-128, 127, (2, 2, 2)).astype(np.int8),
            "u16": rng.integers(0, 60000, (7,)).astype(np.uint16),
            "bool": rng.uniform(size=(4, 3)) > 0.5,
            "empty": np.zeros((0, 3), np.float32),
            "scalar_array": np.asarray(2.5, np.float32),
            "big": rng.normal(size=(100, 100)).astype(np.float32),
        },
        "np_scalars": [np.float32(1.25), np.int64(-7), np.uint8(200), np.bool_(True)],
        "nested": {"a": {"b": {"c": [1, [2, [3, {"d": "e"}]]]}}},
        "long_list": list(range(20)),
        "many_keys": {f"k{i}": i for i in range(40)},
    }
    data = _packed(obj)
    ref = msgpack.unpackb(data, ext_hook=serialization._msgpack_ext_unpack, raw=False)
    _same(checkpoint.unpackb(data), ref)
    assert checkpoint.unpackb(_packed(1)) == 1
    # flax's own writer, the chunked form of an oversized leaf
    tree = {"params": {"w": np.arange(10, dtype=np.float32)}}
    state = serialization.msgpack_serialize(tree)
    _same(checkpoint.msgpack_restore(state), serialization.msgpack_restore(state))
    chunked = {"w": {"__msgpack_chunked_array__": True, "shape": {"0": 2, "1": 3},
                     "chunks": {"0": np.arange(4.0), "1": np.arange(4.0, 6.0)}}}
    out = checkpoint.msgpack_restore(_packed(chunked))
    np.testing.assert_array_equal(out["w"], np.arange(6.0).reshape(2, 3))
    with pytest.raises(ValueError, match="after the msgpack object"):
        checkpoint.unpackb(data + b"\x00")
    with pytest.raises(ValueError, match="ends at byte"):
        checkpoint.unpackb(data[:-3])


def test_missing_checkpoint_raises_with_its_path(tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError, match="nowhere.msgpack"):
        checkpoint.load_variables(tmp_path / "nowhere.msgpack")
    monkeypatch.setattr(tnn, "PRETRAINED", tmp_path / "gone.msgpack")
    with pytest.raises(FileNotFoundError, match="gone.msgpack"):
        tnn.create_model(device="cpu")


def test_converter_checks_every_leaf():
    variables = checkpoint.load_variables(BUNDLED)
    sd = convert.midas_small_from_flax(variables)
    assert set(sd) == set(MidasSmall().state_dict())
    w = variables["params"]["MBConv_3"]["Conv_1"]["kernel"]  # depthwise (5, 5, 1, 144)
    assert tuple(sd["blocks.3.dw.weight"].shape) == (144, 1, 5, 5)
    np.testing.assert_array_equal(sd["blocks.3.dw.weight"].numpy(), np.transpose(w, (3, 2, 0, 1)))
    np.testing.assert_array_equal(sd["fusions.2.skip_unit.conv1.bias"].numpy(),
                                  variables["params"]["FeatureFusion_2"]["ResidualConvUnit_0"]
                                  ["Conv_1"]["bias"])
    np.testing.assert_array_equal(sd["blocks.9.project_bn.running_var"].numpy(),
                                  variables["batch_stats"]["MBConv_9"]["BatchNorm_2"]["var"])
    extra = {**variables, "params": {**variables["params"], "Conv_9": {"kernel": w}}}
    with pytest.raises(ValueError, match="no counterpart.*Conv_9"):
        convert.midas_small_from_flax(extra)
    short = {**variables, "params": {k: v for k, v in variables["params"].items()
                                     if k != "Conv_7"}}
    with pytest.raises(ValueError, match="no flax leaf fills.*head2"):
        convert.midas_small_from_flax(short)
    bad = {**variables, "params": {**variables["params"], "Conv_0": {"kernel": w}}}
    with pytest.raises(ValueError, match="shape mismatch.*Conv_0"):
        convert.midas_small_from_flax(bad)


def test_midas_small_matches_flax_apply(reference):
    model, variables = reference
    port = tnn.create_model(device="cpu")
    assert not port.training
    x = np.random.default_rng(1).uniform(0, 1, (2, 256, 256, 3)).astype(np.float32)
    ref = np.asarray(model.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 256, 256) and got.min() >= 0
    span = ref.max() - ref.min()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * span)


def test_estimate_depth_matches(reference):
    """236×422, the fused cell's processing size: the resize to 256×256
    shrinks one axis and stretches the other."""
    model, variables = reference
    port = tnn.create_model(device="cpu")
    frame = np.random.default_rng(2).uniform(0, 255, (236, 422, 3)).astype(np.float32)
    rd, rc = jax.jit(jnn.estimate_depth, static_argnames=("model", "net_hw"))(
        model, variables, jnp.asarray(frame))
    d, c = tnn.estimate_depth(port, torch.from_numpy(frame), device="cpu")
    assert d.shape == (236, 422) and c.shape == (236, 422)
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=0, atol=0.05)
    np.testing.assert_allclose(c.numpy(), np.asarray(rc), rtol=0, atol=1e-5)
    assert abs(float(d.max()) - 255.0) < 1e-2 and float(d.min()) >= 0.0
    u8 = tnn.estimate_depth(port, frame.astype(np.uint8), device="cpu")[0]
    assert u8.shape == (236, 422)


def test_create_model_options():
    # the exact architectures (tests/test_torch_midas_v21.py, test_torch_dpt.py)
    assert type(tnn.create_model(arch="midas_v21_small", device="cpu")).__name__ == "MidasV21Small"
    with pytest.raises(ValueError, match="DPT_Large: missing keys"):
        tnn.create_model(arch="dpt_large", torch_state_dict={}, device="cpu")
    with pytest.raises(ValueError, match="not 'small'"):
        tnn.create_model(torch_state_dict={}, device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        tnn.create_model(arch="tiny", device="cpu")
    a, b = (tnn.create_model(pretrained=False, seed=3, device="cpu") for _ in range(2))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    n = sum(p.numel() for p in a.parameters())
    n_ref = sum(np.asarray(v).size for _, v in _leaves(checkpoint.load_variables(BUNDLED)["params"]))
    assert n == n_ref and 1e6 < n < 3e7
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tnn.create_model()
