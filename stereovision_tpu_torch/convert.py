"""Carry the JAX package's state across to the port.

Every function takes plain Python/numpy data, never JAX objects, so this
module imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from stereovision_tpu_torch.stereo.sgm import SGMParams
from stereovision_tpu_torch.utils.backend import resolve_device


def sgm_params_from_dict(d: dict) -> SGMParams:
    """``dataclasses.asdict`` of a reference ``SGMParams`` → the port's
    ``SGMParams`` (same fields; an unknown field raises ``TypeError``)."""
    return SGMParams(**d)


def calibration_from_numpy(cal: dict, device="cuda") -> dict:
    """A ``CalibrationStore`` dict of numpy arrays (K, dist, R1/R2, P1/P2, T,
    Q, img_size, ...) → the same keys as tensors on ``device``, float64
    kept; string entries (``_length_unit``) pass through."""
    dev = resolve_device(device)
    out = {}
    for key, value in cal.items():
        arr = np.asarray(value)
        out[key] = value if arr.dtype.kind in "USO" else torch.tensor(arr, device=dev)
    return out


def _midas_table() -> dict:
    """flax variable path → the port's ``MidasSmall`` state_dict key, by
    module name. Conv kernels map onto ``.weight``, their biases onto
    ``.bias``; a BatchNorm's scale/bias onto ``.weight``/``.bias`` and its
    batch statistics mean/var onto ``running_mean``/``running_var``."""
    from stereovision_tpu_torch.models.midas import ENCODER

    table = {}

    def conv(flax_mod, torch_mod, bias):
        table[("params", *flax_mod, "kernel")] = f"{torch_mod}.weight"
        if bias:
            table[("params", *flax_mod, "bias")] = f"{torch_mod}.bias"

    def bn(flax_mod, torch_mod):
        for leaf, key in (("scale", "weight"), ("bias", "bias")):
            table[("params", *flax_mod, leaf)] = f"{torch_mod}.{key}"
        for leaf, key in (("mean", "running_mean"), ("var", "running_var")):
            table[("batch_stats", *flax_mod, leaf)] = f"{torch_mod}.{key}"

    conv(("Conv_0",), "stem", False)
    bn(("BatchNorm_0",), "stem_bn")
    for i, (_, expand, _, _) in enumerate(ENCODER):
        blk = f"MBConv_{i}"
        parts = (("expand_conv", "expand_bn"),) if expand != 1 else ()
        parts += (("dw", "dw_bn"), ("project", "project_bn"))
        for j, (c, b) in enumerate(parts):
            conv((blk, f"Conv_{j}"), f"blocks.{i}.{c}", False)
            bn((blk, f"BatchNorm_{j}"), f"blocks.{i}.{b}")
    for j in range(4):  # p32, p16, p8, p4
        conv((f"Conv_{j + 1}",), f"taps.{j}", False)

    def rcu(flax_mod, torch_mod):
        conv((*flax_mod, "Conv_0"), f"{torch_mod}.conv0", True)
        conv((*flax_mod, "Conv_1"), f"{torch_mod}.conv1", True)

    rcu(("ResidualConvUnit_0",), "top_unit")
    for i in range(4):
        ff = f"FeatureFusion_{i}"
        units = ("unit",) if i == 0 else ("skip_unit", "unit")
        for j, u in enumerate(units):
            rcu((ff, f"ResidualConvUnit_{j}"), f"fusions.{i}.{u}")
        conv((ff, "Conv_0"), f"fusions.{i}.out_conv", True)
    for j, head in enumerate(("head0", "head1", "head2")):
        conv((f"Conv_{j + 5}",), head, True)
    return table


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def midas_small_from_flax(variables: dict) -> dict:
    """flax ``MidasSmall`` variables ({'params', 'batch_stats'}: nested dicts
    of numpy arrays, as ``models.checkpoint.load_variables`` returns them)
    → a ``state_dict`` for the port's ``models.midas.MidasSmall``, through
    an explicit table of module names. Conv kernels go from HWIO to OIHW
    (a depthwise (kh, kw, 1, C) becomes (C, 1, kh, kw)). Every shape is
    checked against the port's module; a flax leaf the table does not know,
    or a parameter of the port's that no leaf fills, raises."""
    from stereovision_tpu_torch.models.midas import MidasSmall

    want = MidasSmall().state_dict()
    table = _midas_table()
    out = {}
    unknown = []
    for path, leaf in _leaves(variables):
        key = table.get(path)
        if key is None:
            unknown.append("/".join(path))
            continue
        arr = np.asarray(leaf)
        if path[-1] == "kernel":
            arr = np.transpose(arr, (3, 2, 0, 1))  # HWIO → OIHW
        if key not in want or tuple(want[key].shape) != arr.shape:
            raise ValueError(f"shape mismatch mapping {'/'.join(path)} {arr.shape} onto {key} "
                             f"{tuple(want[key].shape) if key in want else '(no such key)'}")
        out[key] = torch.tensor(arr, dtype=want[key].dtype)
    if unknown:
        raise ValueError(f"flax leaves with no counterpart in the port: {unknown}")
    for key, t in want.items():  # batch norms' update counters: not in flax
        if key.endswith("num_batches_tracked"):
            out[key] = torch.zeros_like(t)
    missing = sorted(set(want) - set(out))
    if missing:
        raise ValueError(f"parameters of the port's MidasSmall that no flax leaf fills: {missing}")
    return out


def midas_small_to_flax(state_dict) -> dict:
    """The inverse of :func:`midas_small_from_flax`: a ``state_dict`` of the
    port's ``MidasSmall`` (tensors or arrays) → flax variables
    ({'params', 'batch_stats'}: nested dicts of float32 numpy arrays) that
    ``models.checkpoint.save_variables`` writes and the reference's
    ``load_variables`` reads, through the same table. Conv weights go from
    OIHW back to HWIO; the batch norms' ``num_batches_tracked`` counters
    (not in flax) are dropped. A key the table does not know, or a flax
    leaf no key fills, raises."""
    inverse = {key: path for path, key in _midas_table().items()}
    out: dict = {}
    unknown = []
    for key, value in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        path = inverse.get(key)
        if path is None:
            unknown.append(key)
            continue
        arr = np.asarray(value.detach().cpu() if torch.is_tensor(value) else value, np.float32)
        if path[-1] == "kernel":
            arr = np.transpose(arr, (2, 3, 1, 0))  # OIHW → HWIO
        node = out
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    if unknown:
        raise ValueError(f"state_dict keys with no counterpart in flax's MidasSmall: {unknown}")
    missing = sorted("/".join(path) for key, path in inverse.items() if key not in state_dict)
    if missing:
        raise ValueError(f"flax leaves of MidasSmall that no state_dict key fills: {missing}")
    return out


# flax leaf name → the hub's (a conv's or Dense's kernel, a norm's scale,
# batch statistics)
_HUB_LEAF = {"kernel": "weight", "scale": "weight", "mean": "running_mean", "var": "running_var"}


def _hub_from_flax(variables: dict, want: dict, what: str) -> dict:
    """flax variables whose module names are hub state_dict prefixes with
    "." written "__" (the JAX package's exact MiDaS architectures) → a
    hub-format ``state_dict`` of float32 tensors, by name: conv kernels
    HWIO → OIHW, Dense kernels (in, out) → weight (out, in), ``scale`` →
    ``weight``, batch statistics mean/var → ``running_mean``/``running_var``;
    a transposed convolution's ``weight`` (the torch layout already) and a
    module's own parameters (``cls_token``, ``pos_embed``) verbatim. Every
    leaf is checked against ``want`` (key → shape); a leaf with no
    counterpart, a shape that differs or a key no leaf fills raises."""
    out, unknown = {}, []
    for path, leaf in _leaves(variables):
        arr = np.asarray(leaf)
        names = path[1:]  # below the collection ('params' or 'batch_stats')
        if len(names) == 1:  # a module's own parameter
            key = names[0].replace("__", ".")
        else:
            if names[-1] == "kernel":
                arr = np.transpose(arr, (3, 2, 0, 1)) if arr.ndim == 4 else arr.T
            key = f"{names[0].replace('__', '.')}.{_HUB_LEAF.get(names[-1], names[-1])}"
        if len(names) > 2 or key not in want:
            unknown.append("/".join(path))
            continue
        if tuple(want[key]) != arr.shape:
            raise ValueError(f"shape mismatch mapping {'/'.join(path)} {arr.shape} onto {key} "
                             f"{tuple(want[key])}")
        out[key] = torch.tensor(np.ascontiguousarray(arr), dtype=torch.float32)
    if unknown:
        raise ValueError(f"flax leaves with no counterpart in the port's {what}: {unknown[:8]}")
    missing = [k for k in want if k not in out]
    if missing:
        raise ValueError(f"parameters of the port's {what} that no flax leaf fills: {missing[:8]}")
    return {k: out[k] for k in want}


def midas_v21_from_flax(variables: dict) -> dict:
    """The JAX package's ``MidasV21Small`` variables ({'params',
    'batch_stats'}: nested dicts of numpy arrays) → a hub-format
    ``state_dict`` for the port's ``models.midas_v21.MidasV21Small``."""
    from stereovision_tpu_torch.models.midas_v21 import expected_manifest

    return _hub_from_flax(variables, dict(expected_manifest()), "MidasV21Small")


def dpt_from_flax(variables: dict, cfg=None) -> dict:
    """The JAX package's ``DPTDepth(cfg)`` variables ({'params'}: nested
    dicts of numpy arrays) → a hub-format ``state_dict`` for the port's
    ``models.dpt.DPTDepth(cfg)`` (``DPT_LARGE`` by default)."""
    from stereovision_tpu_torch.models.dpt import DPT_LARGE, expected_manifest

    return _hub_from_flax(variables, dict(expected_manifest(cfg or DPT_LARGE)), "DPTDepth")
