"""The port's flax checkpoint writer (``models.checkpoint.packb``,
``msgpack_serialize``, ``save_variables``) and the inverse converter
``convert.midas_small_to_flax``, against ``flax.serialization`` on the CPU:
the port's bytes equal flax's ``to_bytes`` of the same tree, read back
through the port's reader and through flax's ``from_bytes``; the bundled
checkpoint re-written byte for byte; the converter the inverse of
``midas_small_from_flax`` leaf for leaf, its unknown and missing keys
raising.
"""

import numpy as np
import pytest
import torch
from flax import serialization

from stereovision_tpu_torch import convert
from stereovision_tpu_torch.models import checkpoint as ck
from stereovision_tpu_torch.models.midas import MidasSmall
from stereovision_tpu_torch.mono.nn import PRETRAINED


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _tree():
    rng = np.random.default_rng(3)
    return {
        "params": {"Conv_0": {"kernel": rng.standard_normal((3, 3, 3, 32)).astype(np.float32),
                              "bias": np.zeros(0, np.float32)},
                   "Dense": {"kernel": rng.standard_normal((70, 300)).astype(np.float32)}},
        "batch_stats": {"scalar": np.float32(3.5), "ids": np.arange(300, dtype=np.int64),
                        "f64": rng.standard_normal(()).astype(np.float64),
                        "u8": rng.integers(0, 255, (5, 4), dtype=np.uint8)},
        "meta": {"ints": {str(k): v for k, v in enumerate(INTS)},
                 "x": 1.5, "s": "é" * 20, "long": "t" * 300, "none": None, "t": True, "f": False,
                 "b": b"\x00" * 300, "c": 1 + 2j, "wide": {str(k): k for k in range(20)}},
    }


INTS = [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63, -1, -32, -33, -128, -129,
        -32768, -32769, -2 ** 31 - 1, -2 ** 63]


def test_sequences_and_ints_pack_as_msgpack_does():
    """flax's state dicts hold no sequences (``to_state_dict`` makes dicts of
    them); the array extension packs its (shape, dtype, bytes) triple as a
    msgpack array."""
    import msgpack

    for v in (INTS, (1, 2.0, "x"), list(range(20)), [[1], (), "s" * 31, "s" * 32]):
        assert ck.packb(v) == msgpack.packb(v, use_bin_type=True)


def test_bytes_equal_flax_to_bytes():
    tree = _tree()
    data = ck.msgpack_serialize(tree)
    assert data == serialization.to_bytes(tree)
    back = ck.msgpack_restore(data)
    for (path, want), (path_b, got) in zip(_leaves(tree), _leaves(back)):
        assert path == path_b
        if isinstance(want, (np.ndarray, np.generic)):
            assert np.asarray(got).dtype == np.asarray(want).dtype
            np.testing.assert_array_equal(got, want)
        else:
            assert got == want


def test_flax_reads_the_port_file(tmp_path):
    tree = {k: v for k, v in _tree().items() if k != "meta"}
    path = ck.save_variables(tmp_path / "a" / "b.msgpack", tree)
    assert path == tmp_path / "a" / "b.msgpack"
    template = {"params": {"Conv_0": {"kernel": 0, "bias": 0}, "Dense": {"kernel": 0}},
                "batch_stats": {"scalar": 0, "ids": 0, "f64": 0, "u8": 0}}
    restored = serialization.from_bytes(template, path.read_bytes())
    mine = ck.load_variables(path)
    for (p1, a), (p2, b), (p3, c) in zip(_leaves(tree), _leaves(restored), _leaves(mine)):
        assert p1 == p2 == p3
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(c, a)


def test_oversized_arrays_take_flax_chunked_form(monkeypatch):
    monkeypatch.setattr(ck, "_MAX_CHUNK_BYTES", 64)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"w": np.arange(100, dtype=np.float32).reshape(4, 25)}
    data = ck.msgpack_serialize(tree)
    assert data == serialization.to_bytes(tree)
    np.testing.assert_array_equal(ck.msgpack_restore(data)["w"], tree["w"])


def test_the_bundled_checkpoint_is_rewritten_byte_for_byte():
    raw = PRETRAINED.read_bytes()
    tree = ck.msgpack_restore(raw)
    assert ck.msgpack_serialize(tree) == raw
    assert ck.msgpack_serialize(convert.midas_small_to_flax(
        convert.midas_small_from_flax(tree))) == raw


def test_packb_refuses_what_flax_cannot_write():
    with pytest.raises(TypeError, match="no msgpack encoding"):
        ck.packb({"x": object()})
    with pytest.raises(ValueError, match="cannot hold the integer"):
        ck.packb(2 ** 64)
    with pytest.raises(ValueError, match="object and structured dtypes"):
        ck.packb(np.array([None, 1], dtype=object))


def test_midas_small_to_flax_inverts_from_flax():
    variables = ck.load_variables(PRETRAINED)
    state = convert.midas_small_from_flax(variables)
    back = convert.midas_small_to_flax(state)
    want = dict(_leaves(variables))
    got = dict(_leaves(back))
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert v.dtype == np.float32 and v.shape == want[k].shape, k
        np.testing.assert_array_equal(v, want[k])
    # a depthwise kernel: (C, 1, kh, kw) back to (kh, kw, 1, C)
    assert state["blocks.1.dw.weight"].shape == (96, 1, 3, 3)
    assert back["params"]["MBConv_1"]["Conv_1"]["kernel"].shape == (3, 3, 1, 96)


def test_midas_small_to_flax_refuses_unknown_and_missing_keys():
    state = MidasSmall().state_dict()
    with pytest.raises(ValueError, match="no counterpart in flax's MidasSmall: \\['extra'\\]"):
        convert.midas_small_to_flax({**state, "extra": torch.zeros(1)})
    state.pop("head2.bias")
    with pytest.raises(ValueError, match="no state_dict key fills: \\['params/Conv_7/bias'\\]"):
        convert.midas_small_to_flax(state)
