"""Offline pretraining of MidasSmall on procedural scenes, in PyTorch.

The counterpart of ``stereovision_tpu/models/train_synthetic.py``. Loss =
MiDaS-style scale-and-shift-invariant MSE on inverse depth + a multi-scale
gradient-matching term (sharp depth edges at occlusions) + a soft penalty
on negatively correlated predictions.

As in the reference, every variable trains, the batch norms' running mean
and variance included: the network stays in eval mode (each batch norm
normalises with its running statistics, ``models.midas.BatchNorm``) and
Adam moves those statistics like weights. The variables are the floating
tensors of the model's ``state_dict`` held as leaves and applied with
``torch.func.functional_call``. The initial weights come from a seeded
``torch.Generator`` (``mono.nn.create_model(pretrained=False, seed=...)``),
not from flax's ``init``; :func:`train` takes any starting state.

    python -m stereovision_tpu_torch.models.train_synthetic --steps 2000 \\
        --out build/midas_synthetic.msgpack

The result is a flax msgpack checkpoint (``models.checkpoint.save_variables``
of ``convert.midas_small_to_flax``), the format of the bundled weights.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
from torch.func import functional_call


def ssi_align(pred, target):
    """Per-image least-squares scale+shift of pred onto target."""
    p = pred.reshape(pred.shape[0], -1)
    t = target.reshape(target.shape[0], -1)
    pm = p.mean(dim=1, keepdim=True)
    tm = t.mean(dim=1, keepdim=True)
    cov = ((p - pm) * (t - tm)).mean(dim=1, keepdim=True)
    var = ((p - pm) ** 2).mean(dim=1, keepdim=True) + 1e-8
    s = cov / var
    return (p - pm) * s + tm, t


def sign_penalty(pred, target):
    """Mean negative-correlation penalty: pushes images whose prediction is
    negatively correlated with the target toward positive correlation, and
    vanishes once they get there."""
    p = pred.reshape(pred.shape[0], -1)
    t = target.reshape(target.shape[0], -1)
    pm = p.mean(dim=1, keepdim=True)
    tm = t.mean(dim=1, keepdim=True)
    cov = ((p - pm) * (t - tm)).mean(dim=1)
    var_p = ((p - pm) ** 2).mean(dim=1)
    var_t = ((t - tm) ** 2).mean(dim=1)
    corr = cov / torch.sqrt(var_p * var_t + 1e-10)
    return torch.relu(-corr).mean()


def loss_fn(model, variables: dict, imgs, invd):
    """The training loss of ``model`` run on ``variables`` (state_dict name
    → tensor) for (B, S, S, 3) images in 0..255 and (B, S, S) inverse
    depth."""
    pred = functional_call(model, variables, (imgs / 255.0,))
    pa, t = ssi_align(pred, invd)
    mse = ((pa - t) ** 2).mean()
    mse = mse + 0.02 * sign_penalty(pred, invd)
    # gradient matching at 2 scales
    pr = pa.reshape(invd.shape)
    tr = t.reshape(invd.shape)
    g = 0.0
    for k in (1, 2):
        gx = (torch.diff(pr[:, :, ::k], dim=2) - torch.diff(tr[:, :, ::k], dim=2)).abs().mean()
        gy = (torch.diff(pr[:, ::k, :], dim=1) - torch.diff(tr[:, ::k, :], dim=1)).abs().mean()
        g = g + gx + gy
    return mse + 0.3 * g


def trainable_variables(model) -> dict:
    """Every floating tensor of ``model``'s state_dict (weights, biases and
    the batch norms' running statistics; ``num_batches_tracked`` left out)
    as a fresh leaf that requires grad."""
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in model.state_dict().items() if v.is_floating_point()}


def make_optimizer(variables: dict, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``'s counterpart: b1 0.9, b2 0.999, eps 1e-8."""
    return torch.optim.Adam(list(variables.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def train_step(model, variables: dict, opt, imgs, invd):
    """One Adam step on a batch; returns the batch's loss before the step
    (a tensor on the device: reading it waits for the card)."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(model, variables, imgs, invd)
    loss.backward()
    opt.step()
    return loss.detach()


def train(model, variables: dict, *, steps: int, batch: int, size: int, lr: float, seed: int,
          device):
    """The reference's loop from any starting state: batches from
    ``np.random.default_rng(seed)``, validation on 32 scenes from
    ``np.random.default_rng(10_000)``, the initial validation loss, then
    every 100 steps train, val and ms/step. Returns (variables, the final
    validation loss)."""
    from stereovision_tpu_torch.models.synthetic_scenes import batch as make_batch
    from stereovision_tpu_torch.utils.backend import upload

    rng = np.random.default_rng(seed)
    val_imgs, val_invd = (upload(a, device) for a in
                          make_batch(np.random.default_rng(10_000), 32, size))

    def val_loss():
        with torch.no_grad():
            return float(loss_fn(model, variables, val_imgs, val_invd))

    opt = make_optimizer(variables, lr)
    print(f"initial val loss: {val_loss():.5f}")
    t0 = time.time()
    for it in range(steps):
        imgs, invd = make_batch(rng, batch, size)
        loss = train_step(model, variables, opt, upload(imgs, device), upload(invd, device))
        if (it + 1) % 100 == 0:
            print(f"step {it+1}/{steps}  train {float(loss):.5f}  "
                  f"val {val_loss():.5f}  "
                  f"({(time.time()-t0)/(it+1)*1000:.0f} ms/step)")
    return variables, val_loss()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="stereovision_tpu_torch.models.train_synthetic")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/midas_synthetic.msgpack")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from stereovision_tpu_torch.convert import midas_small_to_flax
    from stereovision_tpu_torch.models.checkpoint import save_variables
    from stereovision_tpu_torch.mono.nn import create_model
    from stereovision_tpu_torch.utils.backend import resolve_device

    dev = resolve_device(args.device)
    model = create_model(pretrained=False, seed=args.seed, device=dev)
    variables, final = train(model, trainable_variables(model), steps=args.steps,
                             batch=args.batch, size=args.size, lr=args.lr, seed=args.seed,
                             device=dev)
    path = save_variables(args.out, midas_small_to_flax(variables))
    print(f"saved → {path}  final val {final:.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
