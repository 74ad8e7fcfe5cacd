"""Seeded weights for the exact MiDaS architectures' parity tests (MiDaS
v2.1 small, DPT), in both forms: flax variables for the JAX package's
modules and hub-format state_dicts for the port's.

Both fill every leaf, biases and batch statistics included: the flax
initializers and PyTorch's leave biases at zero and batch norms at the
identity, under which a bias dropped or a mean and variance swapped in a
conversion would not show.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch import nn


def flax_template(model, hw):
    """The variables tree of ``model.init`` at (1, *hw, 3) as numpy zeros
    (``jax.eval_shape``: nothing is compiled or run)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3), jnp.float32))
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)


def _draw(rng, name, shape, fan_in):
    if name in ("kernel", "weight") and fan_in:
        return rng.normal(0.0, fan_in ** -0.5, shape)
    if name in ("scale", "weight", "var", "running_var"):
        return rng.uniform(0.5, 1.5, shape)
    return rng.normal(0.0, 0.1, shape)  # biases, means, cls_token, pos_embed


def random_flax_variables(template, seed):
    """``template`` with every leaf drawn from ``seed``: kernels normal with
    std 1/√fan_in (a transposed convolution's torch-layout ``weight`` fans
    in over its first axis), norm scales and variances in [0.5, 1.5],
    biases, means and the ViT's tokens normal with std 0.1; float32."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        fan_in = {"kernel": int(np.prod(leaf.shape[:-1])),
                  "weight": leaf.shape[0]}.get(name)
        return _draw(rng, name, leaf.shape, fan_in).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, template)


def random_state_dict(module: nn.Module, seed):
    """``module.state_dict()`` with every entry drawn from ``seed`` by the
    same rules (convolution and linear weights fan in over all but their
    first axis, a transposed convolution's over its first); float32
    tensors, ``num_batches_tracked`` kept."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, t in module.state_dict().items():
        prefix, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            out[key] = t.clone()
            continue
        owner = module.get_submodule(prefix)
        fan_in = None
        if leaf == "weight" and t.ndim >= 2:
            fan_in = t.shape[0] if isinstance(owner, nn.ConvTranspose2d) else t[0].numel()
        out[key] = torch.from_numpy(_draw(rng, leaf, tuple(t.shape), fan_in).astype(np.float32))
    return out


def reference_hub_model(arch="small", torch_state_dict=None):
    """Stands in for the reference's ``mono.nn.create_model(arch=
    "midas_v21_small", torch_state_dict=path)``: the same (MidasV21Small(),
    variables) pair, the checkpoint read as the reference reads it and
    loaded by its ``load_v21_state_dict`` into a template, without the
    reference's random ``init`` (~30 s eagerly on the CPU), which the
    checkpoint overwrites whole."""
    from stereovision_tpu.models import midas_v21 as jv21

    assert arch == "midas_v21_small" and torch_state_dict is not None, (arch, torch_state_dict)
    model = jv21.MidasV21Small()
    sd = torch.load(torch_state_dict, map_location="cpu")
    variables = jv21.load_v21_state_dict(flax_template(model, (64, 64)), sd)
    return model, jax.device_put(variables)
