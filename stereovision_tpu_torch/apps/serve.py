"""Streaming depth service: a long-running process that loads calibration
and builds the pipeline ONCE, then serves frame pairs as they arrive. The
counterpart of ``stereovision_tpu.apps.serve``, with its flags plus
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions).
Two front-ends:

- JSON-lines on stdin (default): one request object per line, one response
  line per request on stdout —
      {"left": "l.png", "right": "r.png", "id": 7, "out": "outdir"}
      {"cmd": "ping"} | {"cmd": "stats"} | {"cmd": "shutdown"}
      {"cmd": "set", "params": {"stereo_weight": 0.7, "min_depth": 0.5}}
          — live-tune FusionParams fields / the metric depth window
      {"cmd": "rescale", "scale": 0.5}
          — rebuild the rectify maps and the disparity scaling mid-stream
- hot folder (``--watch DIR``): poll for new ``left_*``/``right_*`` pairs
  and process each once (``--batch`` pairs at a time in depth mode).

The device work of request i overlaps the decode and write of its
neighbours: frames go up through pinned memory without a host wait
(``utils.backend.upload``) and PyTorch queues the pipeline's launches
without waiting for them, so the host waits for the card only where
:meth:`_Server.finalize` copies a result down.

Frames are read by ``io.frames.imread_gray`` (binary PGM/PPM by its own
decoder, JPEG/PNG through the native loader where it builds, else
``imageio``); ``--save-png`` needs ``imageio`` and ``matplotlib`` and
stops at start without them.

    python -m stereovision_tpu_torch.apps.serve --calib output --mode depth
    python -m stereovision_tpu_torch.apps.serve --calib output --watch captures_stereo --once
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def _discover_pairs(d: Path, seen: set) -> list:
    """New (left, right) pairs in d, by the left_*/right_* twin convention."""
    out = []
    for lp in sorted(d.glob("left_*")):
        if lp.suffix.lower() not in (".png", ".jpg", ".jpeg", ".pnm", ".pgm"):
            continue
        rp = lp.with_name("right_" + lp.name[len("left_"):])
        if lp.name not in seen and rp.exists():
            seen.add(lp.name)
            out.append((lp, rp))
    return out


def _host(t) -> np.ndarray:
    """A result tensor → numpy on the host (waits for the card)."""
    return t.detach().cpu().numpy()


class _Server:
    def __init__(self, args):
        self.args = args
        self.stats = {"frames": 0, "total_ms": 0.0, "t_start": time.perf_counter()}
        self._build_pipe()

    def _build_pipe(self):
        if self.args.mode == "depth":
            from stereovision_tpu_torch.pipeline import DepthPipeline

            self.pipe = DepthPipeline.from_store(
                self.args.calib, num_disparities=self.args.num_disparities,
                mode=self.args.sgm_mode, refine_range=self.args.refine_range,
                proc_scale=self.args.proc_scale, device=self.args.device,
            )
        else:
            from stereovision_tpu_torch.pipeline import FusedPipeline

            self.pipe = FusedPipeline.from_store(
                self.args.calib, scale=self.args.scale, device=self.args.device
            )

    def set_params(self, params: dict) -> dict:
        """{"cmd": "set"} handler: FusionParams fields (fused mode) and
        min/max depth (depth mode)."""
        import dataclasses

        resp = {"ok": True}
        depth_keys = {k: params.pop(k) for k in ("min_depth", "max_depth")
                      if k in params}
        if depth_keys:
            if not hasattr(self.pipe, "set_depth_range"):
                return {"ok": False, "error": "depth range applies to depth mode"}
            lo, hi = self.pipe.set_depth_range(
                depth_keys.get("min_depth"), depth_keys.get("max_depth"))
            resp["depth_range"] = [lo, hi]
        if params:
            if not hasattr(self.pipe, "set_params"):
                return {"ok": False,
                        "error": f"fusion params in depth mode: {sorted(params)}"}
            try:
                fp = self.pipe.set_params(**params)
            except TypeError as e:
                return {"ok": False, "error": f"unknown param: {e}"}
            resp["fusion_params"] = dataclasses.asdict(fp)
        return resp

    def rescale(self, scale: float) -> dict:
        """{"cmd": "rescale"} handler: rebuild the rectify maps and the
        disparity scaling at a new processing scale, mid-stream, clamped to
        [0.3, 1.0]."""
        scale = min(1.0, max(0.3, float(scale)))
        if self.args.mode == "depth":
            self.args.proc_scale = scale
        else:
            self.args.scale = scale
        self._build_pipe()
        return {"ok": True, "scale": scale,
                "proc_size": list(getattr(self.pipe, "proc", None)
                                  or self.pipe.proc_size)}

    def dispatch(self, req):
        """Decode + launch device compute (queued, not waited for); returns
        the in-flight record finalize() turns into a response."""
        from stereovision_tpu_torch.io.frames import imread_gray
        from stereovision_tpu_torch.utils.backend import upload

        t0 = time.perf_counter()
        left = upload(imread_gray(req["left"]), self.pipe.device)
        right = upload(imread_gray(req["right"]), self.pipe.device)
        if self.args.mode == "depth":
            out = self.pipe(left, right)
        else:
            out = self.pipe(left, right, t_now=time.monotonic())
        return {"req": req, "out": out, "t0": t0}

    def dispatch_batch(self, reqs: list):
        """Depth-mode throughput path: ≥2 pending pairs go up as one stack
        through ``DepthPipeline.batch``. Mismatched image sizes fall back to
        per-frame dispatch."""
        from stereovision_tpu_torch.io.frames import imread_gray
        from stereovision_tpu_torch.utils.backend import upload

        t0 = time.perf_counter()
        imgs = [(imread_gray(r["left"]), imread_gray(r["right"])) for r in reqs]
        if len({l.shape for l, _ in imgs} | {r.shape for _, r in imgs}) > 1:
            return [self.dispatch(r) for r in reqs]
        dev = self.pipe.device
        out = self.pipe.batch(upload(np.stack([l for l, _ in imgs]), dev),
                              upload(np.stack([r for _, r in imgs]), dev))
        return [
            {"req": r, "out": out, "batch_index": i, "batch_n": len(reqs), "t0": t0}
            for i, r in enumerate(reqs)
        ]

    def finalize(self, rec):
        """Wait for the device result, write requested artifacts, build the
        response dict."""
        req, out = rec["req"], rec["out"]
        bi = rec.get("batch_index")
        resp = {"ok": True}
        if "id" in req:
            resp["id"] = req["id"]
        arrays = {}
        if self.args.mode == "depth":
            sel = (lambda a: a[bi]) if bi is not None else (lambda a: a)
            arrays = {
                "disparity": _host(sel(out.disparity)),
                "valid": _host(sel(out.confidence)).astype(bool),
                "depth_m": _host(sel(out.depth_m)),
            }
            resp["valid_frac"] = round(float(arrays["valid"].mean()), 4)
            vis_src = arrays["depth_m"]
        elif out is None:  # fused with every method disabled
            resp["ok"] = False
            resp["error"] = "no method produced depth"
            return resp
        else:
            arrays = {
                "fused": _host(out["fused"]),
                "confidence": _host(out["confidence"]),
                "meters": _host(out["meters"]),
            }
            resp["fusion_mode"] = int(out["mode"])
            resp["occlusion"] = str(out["occlusion"])
            resp["camera_moving"] = bool(out["camera_moving"])
            vis_src = arrays["fused"]
        out_dir = Path(req.get("out", self.args.out))
        stem = Path(req["left"]).stem.replace("left_", "") or str(
            self.stats["frames"]
        )
        if self.args.save_npz:
            out_dir.mkdir(parents=True, exist_ok=True)
            p = out_dir / f"serve_{stem}.npz"
            np.savez(p, **arrays)
            resp["out_npz"] = str(p)
        if self.args.save_png:
            import imageio.v2 as iio
            import torch

            from stereovision_tpu_torch.core import image as im

            out_dir.mkdir(parents=True, exist_ok=True)
            v = np.asarray(vis_src, np.float32)
            lo, hi = float(v.min()), float(v.max())
            u8 = ((v - lo) / (hi - lo + 1e-9) * 255).astype(np.uint8)
            cmap = im.apply_colormap(torch.from_numpy(u8), self.args.cmap, bgr=False)
            p = out_dir / f"serve_{stem}.png"
            iio.imwrite(p, cmap.numpy().astype(np.uint8))
            resp["out_png"] = str(p)
        ms = (time.perf_counter() - rec["t0"]) * 1000.0
        if rec.get("batch_n"):  # amortized share of the batch's wall time
            ms /= rec["batch_n"]
        resp["ms"] = round(ms, 1)
        self.stats["frames"] += 1
        self.stats["total_ms"] += ms
        return resp

    def stats_resp(self):
        n = self.stats["frames"]
        wall = time.perf_counter() - self.stats["t_start"]
        return {
            "ok": True, "frames": n,
            "mean_ms": round(self.stats["total_ms"] / n, 1) if n else None,
            "fps": round(n / self.stats["total_ms"] * 1000.0, 2) if n else None,
            "wall_fps": round(n / wall, 2) if n and wall > 0 else None,
        }


def main(argv=None, stdin=None, stdout=None):
    ap = argparse.ArgumentParser(prog="stereovision_tpu_torch.apps.serve")
    ap.add_argument("--calib", default="output")
    ap.add_argument("--mode", choices=["depth", "fused"], default="depth")
    ap.add_argument("--num-disparities", type=int, default=320)
    ap.add_argument("--sgm-mode", choices=["full", "hier", "hier2", "prod"],
                    default="hier")
    ap.add_argument("--refine-range", type=int, default=32,
                    help="hier refine window")
    ap.add_argument("--scale", type=float, default=0.33,
                    help="fused-mode processing scale")
    ap.add_argument("--proc-scale", type=float, default=1.0,
                    help="depth-mode processing scale (live-changeable via "
                    '{"cmd": "rescale"})')
    ap.add_argument("--batch", type=int, default=8,
                    help="watch mode: max pairs per batched dispatch "
                    "(depth mode; 1 disables)")
    ap.add_argument("--out", default="depth_captures")
    ap.add_argument("--save-npz", action="store_true")
    ap.add_argument("--save-png", action="store_true")
    ap.add_argument("--cmap", default="turbo", choices=["turbo", "jet"])
    ap.add_argument("--watch", default=None,
                    help="hot-folder mode: poll DIR for new left_*/right_* pairs")
    ap.add_argument("--poll", type=float, default=0.5, help="watch poll seconds")
    ap.add_argument("--once", action="store_true",
                    help="watch mode: single scan, then exit")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.save_png:
        from stereovision_tpu_torch.apps import require

        require("stereovision_tpu_torch.apps.serve --save-png", "imageio", "matplotlib")
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout

    srv = _Server(args)

    def emit(resp):
        stdout.write(json.dumps(resp) + "\n")
        stdout.flush()

    if args.watch:
        d = Path(args.watch)
        seen: set = set()
        while True:
            new = [{"left": str(lp), "right": str(rp)}
                   for lp, rp in _discover_pairs(d, seen)]
            chunk = max(1, args.batch) if args.mode == "depth" else 1
            pending = None
            for i in range(0, len(new), chunk):
                group = new[i:i + chunk]
                recs = (srv.dispatch_batch(group) if len(group) > 1
                        else [srv.dispatch(group[0])])
                # overlap: finalize the previous dispatch while this one runs
                if pending is not None:
                    for r in pending:
                        emit(srv.finalize(r))
                pending = recs
            if pending is not None:
                for r in pending:
                    emit(srv.finalize(r))
            if args.once:
                break
            time.sleep(args.poll)
        emit(srv.stats_resp())
        return 0

    pending = None
    for line in stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            emit({"ok": False, "error": f"bad json: {e}"})
            continue
        cmd = req.get("cmd")
        if cmd == "shutdown":
            break
        if cmd == "ping":
            if pending is not None:  # keep responses ordered
                emit(srv.finalize(pending))
                pending = None
            emit({"ok": True, "pong": True})
            continue
        if cmd == "stats":
            if pending is not None:
                emit(srv.finalize(pending))
                pending = None
            emit(srv.stats_resp())
            continue
        if cmd == "set":
            if pending is not None:  # apply to frames AFTER this point
                emit(srv.finalize(pending))
                pending = None
            emit(srv.set_params(dict(req.get("params", {}))))
            continue
        if cmd == "rescale":
            if pending is not None:
                emit(srv.finalize(pending))
                pending = None
            try:
                emit(srv.rescale(req["scale"]))
            except (KeyError, ValueError) as e:
                emit({"ok": False, "error": f"rescale needs a scale: {e}"})
            continue
        try:
            rec = srv.dispatch(req)
        except Exception as e:  # bad path, unreadable image, …
            if pending is not None:
                emit(srv.finalize(pending))
                pending = None
            emit({"ok": False, "id": req.get("id"), "error": str(e)})
            continue
        if pending is not None:
            emit(srv.finalize(pending))
        pending = rec
    if pending is not None:
        emit(srv.finalize(pending))
    emit(srv.stats_resp())
    return 0


if __name__ == "__main__":
    sys.exit(main())
