"""The port's synthetic pretraining (``models/synthetic_scenes.py``,
``models/train_synthetic.py``) against the JAX package's, on the CPU.

- The scene generator: the same arrays bit for bit for the same
  ``np.random.Generator`` seeds.
- ``ssi_align``, ``sign_penalty`` and ``loss_fn`` within 1e-6 (absolute;
  losses are ~0.04) on the same inputs, the network's variables the bundled
  checkpoint's on both sides (carried across by
  ``convert.midas_small_from_flax``).
- The gradient of every variable, the batch norms' statistics included,
  against ``jax.value_and_grad`` at size 32, batch 2: each leaf within
  1e-4 of its largest reference magnitude (measured: at most 8e-6).
- Three Adam steps against ``optax.adam`` on the same seeded gradients:
  the variables, ``exp_avg``/``exp_avg_sq`` against ``mu``/``nu`` (each
  leaf within 1e-6 of its largest reference magnitude, about 8 float32
  ulps; measured: at most 1.9e-7) and ``step`` against ``count``. The two
  differ in the order of their float32 operations only: optax takes
  lr·m̂/(√v̂ + eps), torch (lr/bc1)·m/(√v/√bc2 + eps).
- ``main --steps 2 --size 32 --batch 2`` on the CPU writes a checkpoint that
  the reference's ``load_variables`` and the port's reader read to equal
  arrays, and that ``mono.nn.create_model`` loads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stereovision_tpu.models import synthetic_scenes as jscenes
from stereovision_tpu.models import train_synthetic as jtrain
from stereovision_tpu_torch import convert
from stereovision_tpu_torch.models import synthetic_scenes as scenes
from stereovision_tpu_torch.models import train_synthetic as train
from stereovision_tpu_torch.models.midas import MidasSmall

from _fused_rig import few_threads  # noqa: F401 (the module's fixture)
from _fused_rig import reference_model

pytestmark = pytest.mark.usefixtures("few_threads")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, np.asarray(tree)


@pytest.fixture(scope="module")
def start():
    """(flax model, its float32 variables, the port's MidasSmall in eval
    mode, its trainable variables): the bundled checkpoint on both sides."""
    jmodel, jvars = reference_model()
    jvars = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), jvars)
    model = MidasSmall()
    model.load_state_dict(convert.midas_small_from_flax(jax.tree_util.tree_map(np.asarray,
                                                                               jvars)))
    model.eval()
    return jmodel, jvars, model, train.trainable_variables(model)


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_scenes_are_bit_equal(seed):
    for size in (32, 64):
        a = scenes.make_scene(np.random.default_rng(seed), size)
        b = jscenes.make_scene(np.random.default_rng(seed), size)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    for x, y in zip(scenes.batch(np.random.default_rng(seed), 3, 48),
                    jscenes.batch(np.random.default_rng(seed), 3, 48)):
        assert x.dtype == y.dtype == np.float32 and np.array_equal(x, y)


def test_loss_terms_match():
    rng = np.random.default_rng(4)
    pred = rng.uniform(0, 2, (3, 16, 16)).astype(np.float32)
    invd = rng.uniform(0.05, 0.6, (3, 16, 16)).astype(np.float32)
    pred[1] = 2.0 - pred[1] * 0.5 + invd[1]        # one image positively correlated
    pred[2] = -invd[2] * 3.0 + 0.01 * pred[2]      # one inverted: the penalty is non-zero
    pa, t = train.ssi_align(torch.from_numpy(pred), torch.from_numpy(invd))
    ja, jt = jtrain.ssi_align(jnp.asarray(pred), jnp.asarray(invd))
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    got = float(train.sign_penalty(torch.from_numpy(pred), torch.from_numpy(invd)))
    want = float(jtrain.sign_penalty(jnp.asarray(pred), jnp.asarray(invd)))
    assert want > 0.2 and abs(got - want) <= 1e-6


def test_loss_and_gradients_match(start):
    jmodel, jvars, model, variables = start
    imgs, invd = scenes.batch(np.random.default_rng(3), 2, 32)
    loss_w, grads_w = jax.jit(jax.value_and_grad(
        lambda v: jtrain.loss_fn(jmodel, v, jnp.asarray(imgs), jnp.asarray(invd))))(jvars)
    for v in variables.values():
        v.grad = None
    loss = train.loss_fn(model, variables, torch.from_numpy(imgs), torch.from_numpy(invd))
    loss.backward()
    assert abs(float(loss.detach()) - float(loss_w)) <= 1e-6
    got = dict(_leaves(convert.midas_small_to_flax({k: v.grad for k, v in variables.items()})))
    want = dict(_leaves(grads_w))
    assert got.keys() == want.keys()
    assert any(k[0] == "batch_stats" for k in got)   # the statistics train too
    for k, g in got.items():
        scale = np.abs(want[k]).max()
        assert scale > 0, k
        assert np.abs(g - want[k]).max() <= 1e-4 * scale, (k, np.abs(g - want[k]).max(), scale)


def test_adam_steps_match_optax(start):
    _, jvars, model, _ = start
    variables = train.trainable_variables(model)
    opt = train.make_optimizer(variables, lr=3e-4)
    tx = optax.adam(3e-4)

    @jax.jit
    def step(params, state, grads):
        updates, state = tx.update(grads, state)
        return optax.apply_updates(params, updates), state

    params, state = jvars, tx.init(jvars)
    rng = np.random.default_rng(9)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: (rng.standard_normal(x.shape) * 0.01).astype(np.float32), params)
        params, state = step(params, state, grads)
        port_grads = convert.midas_small_from_flax(jax.tree_util.tree_map(np.asarray, grads))
        for k, v in variables.items():
            v.grad = port_grads[k]
        opt.step()
    adam = state[0]
    for name, port_tree, ref_tree in (
            ("variables", {k: v.detach() for k, v in variables.items()}, params),
            ("mu", {k: opt.state[v]["exp_avg"] for k, v in variables.items()}, adam.mu),
            ("nu", {k: opt.state[v]["exp_avg_sq"] for k, v in variables.items()}, adam.nu)):
        got = dict(_leaves(convert.midas_small_to_flax(port_tree)))
        for k, want in _leaves(ref_tree):
            err = np.abs(got[k].astype(np.float64) - want).max()
            assert err <= 1e-6 * np.abs(want).max(), (name, k, err, np.abs(want).max())
    assert int(adam.count) == 3
    assert all(int(opt.state[v]["step"]) == 3 for v in variables.values())


def test_main_writes_a_checkpoint_both_sides_read(tmp_path, monkeypatch, capsys, start):
    from stereovision_tpu.models.checkpoint import load_variables as j_load
    from stereovision_tpu_torch.models.checkpoint import load_variables
    from stereovision_tpu_torch.mono import nn

    out = tmp_path / "deep" / "midas.msgpack"
    assert train.main(["--steps", "2", "--size", "32", "--batch", "2", "--device", "cpu",
                       "--out", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("initial val loss: ") and np.isfinite(float(lines[0].split()[-1]))
    assert lines[-1].startswith(f"saved → {out}  final val ")
    ref = dict(_leaves(j_load(out, start[1])))
    port = dict(_leaves(load_variables(out)))
    assert ref.keys() == port.keys()
    for k, v in port.items():
        assert v.dtype == ref[k].dtype == np.float32 and np.array_equal(v, ref[k]), k
    monkeypatch.setattr(nn, "PRETRAINED", out)
    loaded = nn.create_model(device="cpu").state_dict()
    want = convert.midas_small_from_flax(load_variables(out))
    assert all(torch.equal(loaded[k], want[k]) for k in want)
    seeded = nn.create_model(pretrained=False, device="cpu").state_dict()
    assert not torch.equal(loaded["stem.weight"], seeded["stem.weight"])   # it trained
    assert not torch.equal(loaded["stem_bn.running_mean"], seeded["stem_bn.running_mean"])
