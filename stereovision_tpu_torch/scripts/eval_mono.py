"""The mono-depth network alone against ground truth; the counterpart of
``scripts/eval_mono.py``.

    python -m stereovision_tpu_torch.scripts.eval_mono [--arch small|midas_v21_small]
        [--n 16] [--seed 7000001] [--device cuda]

Scores the network (``mono.nn.create_model(arch)``; ``small`` carries the
bundled synthetic-pretrained weights) with no stereo and no fusion on (a)
held-out procedural scenes of its training distribution
(``models.synthetic_scenes.make_scene`` at 256², seeded far outside the
training stream) and (b) the left views of the ``boxes`` and ``steps``
quality scenes at 360x640, whose disparity ground truth is proportional to
inverse depth. Metrics: scale-and-shift-aligned RMSE over the target's
spread, and δ<1.25. Prints one JSON line per dataset.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from stereovision_tpu_torch.models.synthetic_scenes import make_scene
from stereovision_tpu_torch.mono.nn import create_model, estimate_depth
from stereovision_tpu_torch.scripts.eval_quality import scene_boxes, scene_steps


def ssi_metrics(pred, target, valid=None, digits: int | None = 4):
    """Least-squares scale+shift of pred onto target, then RMSE (relative to
    the target's std) and delta<1.25 on the aligned positive-depth ratio,
    rounded to ``digits`` (None: unrounded)."""
    p = pred.ravel().astype(np.float64)
    t = target.ravel().astype(np.float64)
    if valid is not None:
        m = valid.ravel()
        p, t = p[m], t[m]
    A = np.stack([p, np.ones_like(p)], 1)
    (s, b), *_ = np.linalg.lstsq(A, t, rcond=None)
    pa = s * p + b
    rmse_rel = float(np.sqrt(np.mean((pa - t) ** 2)) / (t.std() + 1e-9))
    # delta on strictly positive parts only (inverse depth is >= 0)
    pos = (t > 1e-6) & (pa > 1e-6)
    if pos.any():
        r = np.maximum(pa[pos] / t[pos], t[pos] / pa[pos])
        delta = float((r < 1.25).mean())
    else:
        delta = float("nan")
    if digits is None:
        return {"ssi_rmse_rel": rmse_rel, "delta_1.25": delta}
    return {"ssi_rmse_rel": round(rmse_rel, digits), "delta_1.25": round(delta, digits)}


def _depth(model, bgr, device):
    return estimate_depth(model, bgr, device=device)[0].cpu().numpy()


def mono_rows(model, arch: str, n: int = 16, seed: int = 7_000_001, device="cuda",
              digits: int | None = 4) -> list[dict]:
    """The script's rows for ``model``: the mean over ``n`` held-out scenes,
    then the two stereo scenes (``digits`` as :func:`ssi_metrics`; the
    held-out mean is of the rounded scores, as the reference's is)."""
    rng = np.random.default_rng(seed)
    accs = []
    for _ in range(n):
        img, invd = make_scene(rng, 256)
        accs.append(ssi_metrics(_depth(model, img[..., ::-1], device), invd, digits=digits))
    row = {"dataset": "procedural_heldout", "n": n, "arch": arch}
    for k in accs[0]:
        mean = float(np.mean([a[k] for a in accs]))
        row[k] = mean if digits is None else round(mean, digits)
    rows = [row]
    for name, fn in (("boxes", scene_boxes), ("steps", scene_steps)):
        left, _, gt, gtv = fn(np.random.default_rng(42), 360, 640)
        bgr = np.repeat(left[..., None], 3, axis=-1)
        rows.append({"dataset": f"stereo_scene_{name}", "arch": arch,
                     **ssi_metrics(_depth(model, bgr, device), gt, valid=gtv, digits=digits)})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="small")
    ap.add_argument("--n", type=int, default=16, help="held-out scenes")
    ap.add_argument("--seed", type=int, default=7_000_001, help="far outside the training stream")
    ap.add_argument("--device", default="cuda", help="the network's device")
    args = ap.parse_args(argv)
    model = create_model(arch=args.arch, device=args.device)
    for row in mono_rows(model, args.arch, args.n, args.seed, args.device):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
