#!/usr/bin/env python3
"""Drive the port's DepthPipeline, its tile-parallel engines and its
measurement scripts on one CUDA card and check them.

    python3 chip_smoke.py

Three paths run through ``DepthPipeline`` at 1280x720, 320 disparities: the
full search with the LR check off (kept so that its time stays comparable), the
full search with it on (``SGMParams(num_disparities=320)``), and the
production path (``production_preset()``: hier2, R=32 windows, census
arbitration and fill). Then the ``parallel`` package runs on a mesh of four
row tiles on the one card, the engine's ``aggregate``/``_wta`` run
under the kernel impl, and the four measurement scripts of
``stereovision_tpu_torch.scripts`` run their variant kernels. Phases, each
of which raises (exit code non-zero, no result line) on failure:

1. print the card's name and power limit (nvidia-smi);
2. build the eleven CUDA sources of ``stereovision_tpu_torch/ops/csrc``
   from the checkout, and three of them again with their measurement
   variants, one nvcc per library, all at once;
3. run one frame of each path recording every kernel launch's inputs, then
   replay each recorded launch against the kernel's plain PyTorch version on
   the same inputs: all must be exact; so must ``wta_stats_from_duals`` on
   seeded int16 volumes (the dtype a census with n_bits + P2 > 127 gives);
4. run each path through ``DepthPipeline`` with the launch counts set to 0
   just before and read just after: every kernel of the path must have
   launched; the result must match the path's plain form (``impl="xla"``) on
   the card and recover the synthetic rigs' shifts (a flat rig at 40 px; for
   the production path a background at 40 px and a box at 200 px);
5. time each path (3 warm-up frames, 20 timed, CUDA events), each kernel's
   launches of one frame of each path (replayed on their recorded inputs)
   beside their bound, plain version and (for shift_gather)
   ``torch.gather``, and the stages around them;
6. the exact row-tiled engine (``SGMParams(num_disparities=320)``) on
   ``make_mesh(frame=1, tile=4, devices=["cuda:0"] * 4)``: the sweep
   strategy on 2 flat-rig frames, the pipelined one on 4, each recorded
   (every launch replayed against its plain version: exact) and counted
   (the chain mode must launch T*T times a frame, or (B+T-1)*T times), and
   each frame equal bit for bit to the single-device engine on the card;
7. ``sharded_disparity`` with ``production_preset()`` on the same mesh,
   recorded (every launch replayed against its plain version: exact) and
   counted (each of the eight kernels must launch), held to the
   reference's seam tolerance against the single-device frame on the
   pixels the search matched (the census fill's column scans cross tile
   seams without bound, in the reference's engine as here; the filled
   pixels' agreement is printed);
8. ``sgm.aggregate`` and ``sgm._wta`` under the kernel impl on the flat
   rig's float32 cost volume (720x1280x320), counted, equal to their plain
   forms and each launch to its plain version;
9. time the two exact strategies (ms per frame; four tiles share one card,
   so this is no scaling number), the chain-mode launches, ``aggregate_dir``
   and ``wta``, each beside its bound, and the host time of one launch
   with and without a device switch (:func:`launch_host_us`);
10. the measurement scripts at their full shapes (``bench_agg_step``,
   ``bench_wta_variants``, ``bench_rdisp`` at D=128 and 320,
   ``bench_sumwta`` at D=128, 384 and 320), each run with the launch
   counts set to 0 just before and read just after: every variant kernel
   is held against its plain version (exact) and timed beside its bound,
   and its family must have launched; then ``aggregate_dir``'s ``wta_out``
   at 720x1280x320 against its plain version, timed beside the plain
   ``aggregate_dir`` launch.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is the card; before that, one ``{"kernels": [...]}`` line.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

H, W, D = 720, 1280, 320
SHIFT = 40            # px, the background's (and the flat pair's) disparity
BOX_SHIFT = 200       # px, the near box's disparity
BOX = (200, 600, 320, 400)  # y0, x0 in the left image, height, width
FOCAL, TX_CM = 700.0, -6.0
SEED = 0
WARMUP, FRAMES = 3, 20
TILES = 4                          # row tiles of the mesh, all on cuda:0
EXACT_FRAMES, PIPE_FRAMES = 2, 4   # batches of the sweep and the pipelined strategy
# H100 SXM peaks (NVIDIA data sheet): device memory rate and the float32
# rate outside the tensor cores, applied to these kernels' compares, adds
# and bit operations
MEM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
SOURCES = "stereovision_tpu_torch/ops/csrc"
REPLACES = "stereovision_tpu/ops/sgm_pallas.py"
# kernel wrapper → (source, line of the TPU kernel's function, plain version)
KERNELS = {
    "census_words": ("census.cu", 81, "census_words_plain"),
    "cost_volume": ("cost.cu", 274, "cost_volume_plain"),
    "aggregate_dual": ("aggregate.cu", 866, "aggregate_dual_plain"),
    "wta_stats_from_duals": ("wta_stats.cu", 1179, "wta_stats_from_duals_plain"),
    "right_disparity": ("right_disparity.cu", 1430, "right_disparity_plain"),
    "shift_gather": ("shift_gather.cu", 1554, "shift_gather_plain"),
    "speckle_counts": ("speckle.cu", 1655, "speckle_counts_plain"),
    "nearest_valid_lohi": ("nearest_lohi.cu", 1770, "nearest_valid_lohi_plain"),
}
# the kernels that only the parallel engines and the engine's aggregate/_wta
# reach; "aggregate_dual_chain" is aggregate_dual's chain mode
SLICE3_KERNELS = {
    "aggregate_dual_chain": ("aggregate.cu", 866, "aggregate_dual_plain"),
    "aggregate_dir": ("aggregate_dir.cu", 595, "aggregate_dir_plain"),
    "wta": ("wta.cu", 1701, "wta_plain"),
}
# the measurement kernels (phase 10): launch-count name → (source, the TPU
# kernel's pallas_call, the row of its script's run that the kernels line
# reports: the shipping kernel's counterpart at the engine's shape)
SLICE4_KERNELS = {
    "sum_wta": ("sum_wta.cu", "scripts/bench_sumwta.py:110", "hwd D={D}"),
    "aggregate_dual_variants": ("aggregate.cu", "scripts/bench_agg_step.py:216", "shipping"),
    "wta_stats_variants": ("wta_stats.cu", "scripts/bench_wta_variants.py:149", "base"),
    "right_disparity_variants": ("right_disparity.cu", "scripts/bench_rdisp.py:84",
                                 "in_place D={D}"),
}
# stages of the production frame, timed by replaying their recorded calls
STAGES = {
    "im": ("remap", "resize", "median_blur"),
    "sgm": ("_coarse_disparity", "_window_shifts", "_refine_two_windows",
            "_census_distance", "_speckle_suppress", "_census_fill"),
    "sgm_cuda": ("st_from_duals", "sum_wta"),
}


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def calibration():
    """Identity-rectified rig: f=700 px, T=(-6, 0, 0) cm."""
    K = np.array([[FOCAL, 0, (W - 1) / 2], [0, FOCAL, (H - 1) / 2], [0, 0, 1]])
    P1 = np.hstack([K, np.zeros((3, 1))])
    P2 = P1.copy()
    P2[0, 3] = TX_CM * FOCAL
    Q = np.array([[1, 0, 0, -K[0, 2]], [0, 1, 0, -K[1, 2]],
                  [0, 0, 0, FOCAL], [0, 0, -1 / TX_CM, 0]])
    return {
        "mtx_left": K, "mtx_right": K, "dist_left": np.zeros(5), "dist_right": np.zeros(5),
        "R": np.eye(3), "T": np.array([[TX_CM], [0.0], [0.0]]),
        "R1": np.eye(3), "R2": np.eye(3), "P1": P1, "P2": P2, "Q": Q,
        "img_size": np.array([W, H]),
    }


def texture(rng, h, w):
    """Seeded noise under a 5x5 box filter, float32."""
    raw = rng.uniform(0, 255, (h + 4, w + 4))
    return (sum(raw[i:i + h, j:j + w] for i in range(5) for j in range(5)) / 25).astype(np.float32)


def flat_pair(seed: int = SEED):
    """A textured 1280x720 pair whose right view is the left shifted by SHIFT."""
    base = texture(np.random.default_rng(seed), H, W + SHIFT)
    return base[:, :W].copy(), base[:, SHIFT:SHIFT + W].copy()


def two_plane_pair():
    """A textured background at SHIFT and a separately textured box at
    BOX_SHIFT: the jump of 160 px is far wider than the R=32 refine window,
    so window B, the census arbitration and the fill all take part."""
    rng = np.random.default_rng(SEED + 1)
    base = texture(rng, H, W + SHIFT)
    left, right = base[:, :W].copy(), base[:, SHIFT:SHIFT + W].copy()
    y0, x0, bh, bw = BOX
    box = texture(rng, bh, bw)
    left[y0:y0 + bh, x0:x0 + bw] = box
    right[y0:y0 + bh, x0 - BOX_SHIFT:x0 - BOX_SHIFT + bw] = box
    return left, right


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def work(name, args, kw):
    """(bytes, operations) of one launch: each input read once, each output
    written once; operations are the function's least count (compares, adds
    and bit operations), from the launch's own inputs."""
    t = args[0]
    if name == "census_words":
        k, w = (args[1:3] + (5, 5))[:2]
        n_bits = k * w - 1
        return t.numel() * 4 * (1 + (n_bits + 31) // 32), t.numel() * n_bits * 3
    if name == "cost_volume":
        nw, h, wd = t.shape
        hwd = h * wd * args[2]
        return 2 * t.numel() * 4 + hwd, hwd * (2 * nw + 1)
    if name == "aggregate_dual":
        out_dtype = kw.get("out_dtype", args[4] if len(args) > 4 else None)
        itemsize = 1 if out_dtype is None else out_dtype.itemsize
        nbytes = t.numel() * (1 + 2 * itemsize)
        if kw.get("boundary") is not None:  # chain mode: two seed rows in, two carries out
            nbytes += 4 * t.shape[1] * t.shape[2] * 4
            if kw.get("cost_b") is not None:
                nbytes += t.numel()
        return nbytes, 2 * 7 * t.numel()
    if name == "aggregate_dir":
        with_acc = kw.get("acc", args[5] if len(args) > 5 else None) is not None
        return 4 * t.numel() * (2 + with_acc), (7 + with_acc) * t.numel()
    if name == "wta":
        return 4 * t.numel() + 20 * t.shape[0] * t.shape[1], 6 * t.numel()
    if name == "wta_stats_from_duals":
        hw = t.shape[0] * t.shape[1]
        return 2 * t.numel() * t.element_size() + 20 * hw, 9 * t.numel()
    if name == "right_disparity":
        # only s[y, u + d, d] with u + d < W is read: W*dv - dv*(dv-1)/2 a row
        h, wd, d = t.shape
        dv = min(args[1] if len(args) > 1 and args[1] is not None else d, wd)
        read = h * (wd * dv - dv * (dv - 1) // 2)
        return read * t.element_size() + 4 * h * wd, 2 * read
    if name == "shift_gather":
        return 2 * t.numel() * 4 + args[1].numel() * 4, 4 * t.numel()
    if name == "speckle_counts":
        # the function's least work, not the kernel's direct k*k loop: per
        # binning, 2 ops to bin a pixel, then per bin an indicator and a
        # separable running window sum (2 ops per pass) = 5; max of the two
        nbins = args[3]
        return 2 * t.numel() * 4, t.numel() * (2 * (2 + 5 * nbins) + 1)
    if name == "nearest_valid_lohi":
        return 17 * t.numel(), 8 * t.numel()
    raise KeyError(name)


class Recorder:
    """While active, the named functions of the given modules record each
    call's arguments (tensors cloned) before running as usual."""

    def __init__(self, torch, targets):
        self.torch = torch
        self.targets = targets  # [(module, name)]
        self.calls = {name: [] for _, name in targets}
        self.saved = []

    def _freeze(self, v):
        return v.clone() if self.torch.is_tensor(v) else v

    def __enter__(self):
        for mod, name in self.targets:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def wrapped(*args, _fn=fn, _name=name, **kw):
                self.calls[_name].append((tuple(self._freeze(a) for a in args),
                                          {k: self._freeze(v) for k, v in kw.items()}))
                return _fn(*args, **kw)

            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self.saved):
            setattr(mod, name, fn)


def wrapper_of(sgm_cuda, kname):
    """The wrapper behind a launch-count name (the chain mode's is
    aggregate_dual)."""
    return getattr(sgm_cuda, "aggregate_dual" if kname == "aggregate_dual_chain" else kname)


def plain_of(sgm_cuda, kname):
    return getattr(sgm_cuda, (KERNELS.get(kname) or SLICE3_KERNELS[kname])[2])


def parity(torch, sgm_cuda, calls, what: str) -> float:
    """Replay each recorded launch (wrapper name → [(args, kwargs)]) through
    the kernel and its plain version, each on its own copy of the inputs
    (``aggregate_dir`` adds onto ``acc`` in place); all must be exact.
    Returns the largest error (0.0)."""
    def fresh(v):
        if torch.is_tensor(v):
            return v.clone()
        if isinstance(v, tuple):
            return tuple(fresh(x) for x in v)
        return v

    worst = 0.0
    for kname, kcalls in calls.items():
        for args, kw in kcalls:
            got = wrapper_of(sgm_cuda, kname)(*fresh(args), **fresh(kw))
            want = plain_of(sgm_cuda, kname)(*fresh(args), **fresh(kw))
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for g, w in zip(got, want):
                check(g.shape == w.shape and g.dtype == w.dtype,
                      f"{kname}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
                err = (g.double() - w.double()).abs().max().item() if g.numel() else 0.0
                check(err == 0.0, f"{kname} differs from its plain version on {what}: "
                                  f"max abs err {err}")
                worst = max(worst, err)
        if kcalls:
            print(f"parity {what} {kname}: {len(kcalls)} launch(es) exact")
        torch.cuda.synchronize()
    return worst


def split_chain(calls):
    """aggregate_dual's recorded launches → the unseeded ones and the chain
    mode's, under their launch-count names."""
    duals = calls.pop("aggregate_dual", [])
    calls["aggregate_dual"] = [c for c in duals if c[1].get("boundary") is None]
    calls["aggregate_dual_chain"] = [c for c in duals if c[1].get("boundary") is not None]
    return calls


def tally(calls):
    """Bytes and operations of recorded launches (chain launches under
    aggregate_dual's work)."""
    nbytes = ops = 0
    for kname, kcalls in calls.items():
        for a, kw in kcalls:
            b, o = work("aggregate_dual" if kname == "aggregate_dual_chain" else kname, a, kw)
            nbytes, ops = nbytes + b, ops + o
    return nbytes, ops


def launch_host_us(torch, sgm_cuda, n: int = 2000):
    """Host µs per launch of shift_gather on one 32-pixel row (host-bound):
    its C entry called bare on the current stream, the same under
    ``torch.cuda.device`` (the device switch ``sgm_cuda._launch`` makes only
    for a tensor off the current device), and the whole wrapper. Run in the
    order ABCCBA; the faster of each pair."""
    src = torch.zeros((1, 32), device="cuda")
    off = torch.zeros((1, 32), dtype=torch.int32, device="cuda")
    out = torch.empty_like(src)
    sgm_cuda.shift_gather(src, off, 1)  # loads the kernel's library
    fn, dev = sgm_cuda._fns["shift_gather"], src.device
    args = (src.data_ptr(), off.data_ptr(), out.data_ptr(), 1, 1, 32, 1)

    def switched():
        with torch.cuda.device(dev):
            fn(*args, torch.cuda.current_stream(dev).cuda_stream)

    forms = {"bare": lambda: fn(*args, torch.cuda.current_stream().cuda_stream),
             "switched": switched, "wrapper": lambda: sgm_cuda.shift_gather(src, off, 1)}
    us = {}
    for name in list(forms) + list(reversed(forms)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            forms[name]()
        t = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        us[name] = min(us.get(name, t), t)
    return us


def parallel_phases(torch, card: str):
    """Phases 6-9; returns the kernels-line rows of the three kernels."""
    from stereovision_tpu_torch import parallel
    from stereovision_tpu_torch.ops import sgm_cuda
    from stereovision_tpu_torch.stereo import SGMParams, production_preset, sgm

    names = list(KERNELS) + ["aggregate_dir", "wta"]
    targets = [(sgm_cuda, n) for n in names]
    p = SGMParams(num_disparities=D)
    mesh = parallel.make_mesh(frame=1, tile=TILES, devices=["cuda:0"] * TILES)
    pairs = [flat_pair(SEED + 10 + i) for i in range(PIPE_FRAMES)]
    lefts, rights = np.stack([a for a, _ in pairs]), np.stack([b for _, b in pairs])
    singles = [sgm.compute_disparity(a, b, p) for a, b in pairs]
    torch.cuda.synchronize()

    # -- 6. the exact engine: recorded, replayed, counted, against one device
    strategies = {
        "sweep": (parallel.sharded_disparity_exact, EXACT_FRAMES, EXACT_FRAMES * TILES * TILES),
        "pipelined": (parallel.sharded_disparity_exact_pipelined, PIPE_FRAMES,
                      (PIPE_FRAMES + TILES - 1) * TILES),
    }
    must = ("census_words", "cost_volume", "aggregate_dual", "aggregate_dual_chain",
            "right_disparity", "shift_gather", "speckle_counts")
    runs = {}
    errs = {"aggregate_dual_chain": 0.0}
    for sname, (fn, B, chain_launches) in strategies.items():
        with Recorder(torch, targets) as rec:
            fn(lefts[:B], rights[:B], p, mesh)
            torch.cuda.synchronize()
        calls = split_chain(rec.calls)
        err = parity(torch, sgm_cuda, calls, f"exact {sname}")
        errs["aggregate_dual_chain"] = max(errs["aggregate_dual_chain"], err)
        sgm_cuda.reset_launch_counts()
        disp, valid = fn(lefts[:B], rights[:B], p, mesh)
        torch.cuda.synchronize()
        counts = sgm_cuda.launch_counts()
        print(f"launches in one {sname} run ({B} frames, {TILES} tiles): {counts}")
        check(counts["aggregate_dual_chain"] == chain_launches,
              f"{sname}: {counts['aggregate_dual_chain']} chain launches, not {chain_launches}")
        for k in must:
            check(counts[k] > 0, f"kernel {k} was not launched by the {sname} strategy")
        check(disp.shape == (B, H, W) and disp.device == mesh.first, f"{sname}: output shape")
        for i in range(B):
            check(torch.equal(valid[i], singles[i][1]) and torch.equal(disp[i], singles[i][0]),
                  f"{sname}: frame {i} differs from the single-device engine")
        core = disp[:, 20:-20, SHIFT + 20:-20][valid[:, 20:-20, SHIFT + 20:-20]]
        med = core.median().item()
        check(abs(med - SHIFT) < 0.5, f"{sname}: median disparity {med} vs {SHIFT}")
        print(f"exact {sname}: {B} frames bit-exact against the single-device engine; valid "
              f"{valid.float().mean().item():.4f}, median disparity {med} (true {SHIFT})")
        runs[sname] = (fn, B, counts, calls["aggregate_dual_chain"], tally(calls))
        del calls, rec, disp, valid
    del singles

    # -- 7. the production preset through the approximate row tiles --------
    pp = production_preset()
    left2, right2 = two_plane_pair()
    d1, _ = sgm.compute_disparity(left2, right2, pp)
    # the pixels the search matched: valid before the census fill, which
    # the same preset without the fill leaves as they are
    _, matched = sgm.compute_disparity(left2, right2, dataclasses.replace(pp, fill_invalid=False))
    # the haloed 226-row slabs take shapes no other phase gives (a 75-row
    # coarse search, the sequential refine): every launch against its plain version
    with Recorder(torch, targets) as rec:
        parallel.sharded_disparity(left2[None], right2[None], pp, mesh)
        torch.cuda.synchronize()
    parity(torch, sgm_cuda, rec.calls, "sharded production")
    del rec
    sgm_cuda.reset_launch_counts()
    disp, valid = parallel.sharded_disparity(left2[None], right2[None], pp, mesh)
    torch.cuda.synchronize()
    counts = sgm_cuda.launch_counts()
    print(f"launches in one production frame on {TILES} tiles: {counts}")
    for k in KERNELS:
        check(counts[k] > 0, f"kernel {k} was not launched by the sharded production frame")
    near = (disp[0] - d1).abs() < 1.0
    close = near[matched].float().mean().item()
    check(bool(valid.all()), "sharded production: the fill_invalid contract broke")
    # the reference's seam tolerance, on the matched pixels: the fill's
    # column scans reach across tile seams without bound, which no halo covers
    check(close > 0.95, f"sharded production: {close} of the matched pixels within 1 px of "
                        "the single-device frame")
    prod_ms = cuda_ms(torch, lambda: parallel.sharded_disparity(left2[None], right2[None], pp,
                                                                mesh), 3)
    print(f"sharded production ({TILES} tiles on one card): {close:.4f} of the matched pixels "
          f"({matched.float().mean().item():.4f} of the frame) within 1 px of the single-device "
          f"frame (tolerance 0.95); all pixels {near.float().mean().item():.4f}, filled ones "
          f"{near[~matched].float().mean().item():.4f}; {prod_ms:.3f} ms/frame, card {card}")
    del disp, valid, d1, matched, near

    # -- 8. aggregate and _wta under the kernel impl ------------------------
    left, right = (torch.as_tensor(a, device="cuda") for a in pairs[0])
    cost = sgm.census_cost_volume(left, right, p)
    check(cost.shape == (H, W, D) and cost.dtype == torch.float32, "cost volume")
    vol_targets = [(sgm_cuda, "aggregate_dir"), (sgm_cuda, "wta")]
    with Recorder(torch, vol_targets) as rec:
        s = sgm.aggregate(cost, p)
        sgm._wta(s, p)
        torch.cuda.synchronize()
    vol_calls = rec.calls
    sgm_cuda.reset_launch_counts()
    s = sgm.aggregate(cost, p)
    got = sgm._wta(s, p)
    torch.cuda.synchronize()
    vol_counts = sgm_cuda.launch_counts()
    print(f"launches of aggregate + _wta at {H}x{W}x{D}: {vol_counts}")
    check(vol_counts["aggregate_dir"] == 4 and vol_counts["wta"] == 1,
          "aggregate/_wta under the kernel impl did not launch aggregate_dir 4x and wta once")
    px = dataclasses.replace(p, impl="xla")
    s_x = sgm.aggregate(cost, px)
    check(torch.equal(s, s_x), "aggregate under the kernel impl differs from the plain scan")
    for g, w_ in zip(got, sgm._wta(s_x, px)):
        check(torch.equal(g, w_), "_wta under the kernel impl differs from the plain form")
    del s_x
    errs.update({k: parity(torch, sgm_cuda, {k: vol_calls[k]}, f"aggregate/_wta {k}")
                 for k in ("aggregate_dir", "wta")})
    print(f"aggregate + _wta (kernel impl) equal the plain forms on the card at {H}x{W}x{D}")

    # -- 9. timing -----------------------------------------------------------
    def replay(fn, calls):
        return lambda: [fn(*a, **kw) for a, kw in calls]

    for sname, (fn, B, counts, _, (nb, ops)) in runs.items():
        ms = cuda_ms(torch, lambda: fn(lefts[:B], rights[:B], p, mesh), 3) / B
        b_ms, b_by = bound_ms(nb, ops)
        print(f"frame exact {sname}: {ms:.3f} ms/frame over {B} frames ({W}x{H}, D={D}, "
              f"{TILES} row tiles sharing one card: not a scaling number; host-to-device copy "
              f"included), its kernels' bound {b_ms / B:.4f} ms/frame ({b_by}), card {card}")
    rows = []
    chain = runs["pipelined"][3]
    timed = {"aggregate_dual_chain": (sgm_cuda.aggregate_dual, chain,
                                      runs["pipelined"][2]["aggregate_dual_chain"],
                                      f"the pipelined run's {len(chain)} chain launches "
                                      f"({PIPE_FRAMES} frames, {TILES} tiles), replayed"),
             "aggregate_dir": (sgm_cuda.aggregate_dir, vol_calls["aggregate_dir"],
                               vol_counts["aggregate_dir"],
                               f"sgm.aggregate's 4 launches at {H}x{W}x{D} float32, replayed"),
             "wta": (sgm_cuda.wta, vol_calls["wta"], vol_counts["wta"],
                     f"sgm._wta's launch at {H}x{W}x{D} float32, replayed")}
    one = chain[:1]
    one_ms = cuda_ms(torch, replay(sgm_cuda.aggregate_dual, one), 20, warmup=3)
    b1 = bound_ms(*tally({"aggregate_dual_chain": one}))
    print(f"kernel aggregate_dual_chain: one launch on a {tuple(one[0][0][0].shape)} slab with "
          f"cost_b: {one_ms:.4f} ms, bound {b1[0]:.4f} ms ({b1[1]})")
    for a, kw in vol_calls["aggregate_dir"]:
        l_ms = cuda_ms(torch, replay(sgm_cuda.aggregate_dir, [(a, kw)]), 5, warmup=1)
        lb = bound_ms(*tally({"aggregate_dir": [(a, kw)]}))
        print(f"kernel aggregate_dir axis {kw.get('axis')} reverse {kw.get('reverse', False)} "
              f"acc {kw.get('acc') is not None}: {l_ms:.4f} ms, bound {lb[0]:.4f} ms ({lb[1]})")
    for kname, (fn, calls, n_launches, how) in timed.items():
        ms = cuda_ms(torch, replay(fn, calls), 5 if kname == "aggregate_dir" else 20, warmup=1)
        plain_ms = cuda_ms(torch, replay(plain_of(sgm_cuda, kname), calls), 1, warmup=0)
        nbytes, ops = tally({kname: calls})
        b_ms, b_by = bound_ms(nbytes, ops)
        print(f"kernel {kname}: {ms:.4f} ms for {len(calls)} launches ({how}), bound "
              f"{b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} G operations), "
              f"plain {plain_ms:.2f} ms")
        src, line, _ = SLICE3_KERNELS[kname]
        rows.append({
            "name": kname, "route": "cuda", "source": f"{SOURCES}/{src}",
            "replaces": f"{REPLACES}:{line}", "launches": n_launches,
            "max_abs_err": errs[kname], "parity": "exact", "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "timed_as": how,
        })
    rows[0]["launches_sweep"] = runs["sweep"][2]["aggregate_dual_chain"]
    us = launch_host_us(torch, sgm_cuda)
    print(f"launch host time: {us['bare']:.2f} µs bare, {us['switched']:.2f} µs under "
          f"torch.cuda.device, {us['wrapper']:.2f} µs through the shift_gather wrapper "
          f"(on the current device: no switch), card {card}")
    return rows


def script_phases(torch, card: str):
    """Phase 10; returns the kernels-line rows of the four measurement
    kernel families."""
    from stereovision_tpu_torch.ops import sgm_cuda
    from stereovision_tpu_torch.scripts import (bench_agg_step, bench_rdisp, bench_sumwta,
                                                bench_wta_variants)

    runs = {
        "aggregate_dual_variants": lambda: bench_agg_step.run(),
        "wta_stats_variants": lambda: bench_wta_variants.run(),
        "right_disparity_variants": lambda: bench_rdisp.run(ds=(128, D)),
        "sum_wta": lambda: bench_sumwta.run(ds=(128, 384, D)),
    }
    rows = []
    for kname, go in runs.items():
        t0 = time.perf_counter()
        sgm_cuda.reset_launch_counts()
        results = go()
        torch.cuda.synchronize()
        counts = sgm_cuda.launch_counts()
        launched = sum(r["launches"] for r in results)
        check(counts[kname] == launched > 0, f"{kname}: {counts[kname]} launches counted, "
                                             f"{launched} made by the script")
        check(all(v == 0 for k, v in counts.items() if k != kname),
              f"the {kname} script launched another kernel: {counts}")
        kernel_rows = [r for r in results if r["launches"]]
        check(all(r["max_abs_err"] == 0.0 for r in kernel_rows), f"{kname}: not exact")
        print(f"script of {kname}: {len(kernel_rows)} kernel variants launched {launched} times, "
              f"all exact against their plain versions; {time.perf_counter() - t0:.1f} s, "
              f"card {card}")
        src, replaces, label = SLICE4_KERNELS[kname]
        label = label.format(D=D)
        pick = next(r for r in results if r["variant"] == label)
        rows.append({
            "name": kname, "route": "cuda", "source": f"{SOURCES}/{src}", "replaces": replaces,
            "launches": counts[kname], "max_abs_err": max(r["max_abs_err"] for r in kernel_rows),
            "parity": "exact", "ms": pick["ms"], "plain_ms": pick["plain_ms"],
            "bound_ms": pick["bound_ms"], "bound_by": pick["bound_by"], "library_ms": None,
            "timed_as": f"the {label} row of the script's run (20 launches after 3 warm-up)",
        })

    # aggregate_dir's wta_out at the engine's full-search shape
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cost = torch.randint(0, 40, (H, W, D), device="cuda", generator=gen).float()
    acc = torch.randint(0, 300, (H, W, D), device="cuda", generator=gen).float()
    got = sgm_cuda.aggregate_dir(cost, 8.0, 96.0, 0, True, acc.clone(), wta_out=True)
    want = sgm_cuda.aggregate_dir_wta_plain(cost, 8.0, 96.0, 0, True, acc.clone())
    for g, w in zip(got, want):
        check(g.dtype == w.dtype and torch.equal(g, w),
              "aggregate_dir with wta_out differs from its plain version")
    del got, want
    with_ms = cuda_ms(torch, lambda: sgm_cuda.aggregate_dir(cost, 8.0, 96.0, 0, True, acc,
                                                            wta_out=True), 5)
    without_ms = cuda_ms(torch, lambda: sgm_cuda.aggregate_dir(cost, 8.0, 96.0, 0, True, acc), 5)
    print(f"aggregate_dir axis 0 reverse acc at {H}x{W}x{D}: wta_out exact against its plain "
          f"version; {with_ms:.4f} ms with wta_out, {without_ms:.4f} ms without, card {card}")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from stereovision_tpu_torch.core import image as im
    from stereovision_tpu_torch.ops import _build, sgm_cuda
    from stereovision_tpu_torch.pipeline import DepthPipeline
    from stereovision_tpu_torch.stereo import SGMParams, production_preset, sgm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    print(f"card: {card}")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    messages = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(messages) or 'none (cached)'}")
    for name, text in sorted(messages.items()):
        regs = sorted({int(tok) for line in text.splitlines() if "registers" in line
                       for tok in [line.split("Used")[1].split()[0]]})
        spills = [line.strip() for line in text.splitlines()
                  if "spill" in line and not line.strip().startswith("0 bytes stack")]
        print(f"  ptxas {name}: registers {regs}{' ' + str(spills) if spills else ''}")

    cal = calibration()
    flat = flat_pair()
    planes = two_plane_pair()
    paths = {
        # name: (params, pair, kernels that must launch)
        "full_lr_off": (SGMParams(num_disparities=D, mode="full", lr_max_diff=-1), flat,
                        ("census_words", "cost_volume", "aggregate_dual", "speckle_counts")),
        "full_lr_on": (SGMParams(num_disparities=D), flat,
                       ("census_words", "cost_volume", "aggregate_dual", "right_disparity",
                        "shift_gather", "speckle_counts")),
        "production": (production_preset(), planes, tuple(KERNELS)),
    }
    pipes = {name: DepthPipeline(cal, p, min_depth=0.2, max_depth=4.0)
             for name, (p, _, _) in paths.items()}

    # -- 3. every kernel launch of one frame of each path against its plain version
    kernel_targets = [(sgm_cuda, name) for name in KERNELS]
    stage_targets = [({"im": im, "sgm": sgm, "sgm_cuda": sgm_cuda}[m], n)
                     for m, names in STAGES.items() for n in names]
    recorded = {}
    for name, (_, (left_np, right_np), _) in paths.items():
        targets = kernel_targets + (stage_targets if name in ("production", "full_lr_on") else [])
        with Recorder(torch, targets) as rec:
            pipes[name](left_np, right_np)
            torch.cuda.synchronize()
        recorded[name] = rec.calls
    errs = {k: max(parity(torch, sgm_cuda, {k: calls[k]}, path)
                   for path, calls in recorded.items()) for k in KERNELS}
    # int16 dual volumes (a census with n_bits + P2 > 127) take the same
    # statistics kernel: seeded volumes at the refine stack's and the full
    # search's shapes
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for shape in ((H + H // 3, W, 32), (H, W, D)):
        hf, hb = (torch.randint(0, 600, shape, dtype=torch.int16, device="cuda", generator=gen)
                  for _ in range(2))
        got = sgm_cuda.wta_stats_from_duals(hf, hb)
        want = sgm_cuda.wta_stats_from_duals_plain(hf, hb)
        for g, w in zip(got, want):
            check(g.dtype == w.dtype and torch.equal(g, w),
                  f"wta_stats_from_duals differs from its plain version on int16 {shape}")
        print(f"parity int16 wta_stats_from_duals: exact at {shape}")
        del hf, hb, got, want

    # -- 4. each path through DepthPipeline, counted -------------------------
    launches = {}
    results = {}
    for name, (p, (left_np, right_np), must) in paths.items():
        pipe = pipes[name]
        sgm_cuda.reset_launch_counts()
        res = pipe(left_np, right_np)
        torch.cuda.synchronize()
        launches[name] = sgm_cuda.launch_counts()
        print(f"launches in one {name} frame: {launches[name]}")
        for k in must:
            check(launches[name][k] > 0, f"kernel {k} was not launched on the {name} path")
        ref = DepthPipeline(cal, dataclasses.replace(p, impl="xla"), min_depth=0.2,
                            max_depth=4.0)(left_np, right_np)
        torch.cuda.synchronize()
        check(sgm_cuda.launch_counts() == launches[name], f"the plain {name} path launched a kernel")
        valid, valid_x = res.disparity > p.min_disparity - 1, ref.disparity > p.min_disparity - 1
        check(torch.equal(valid, valid_x), f"{name}: valid differs from the plain path")
        check(torch.equal(res.confidence, ref.confidence),
              f"{name}: confidence differs from the plain path")
        d_err = (res.disparity - ref.disparity).abs().max().item()
        check(d_err <= 1e-4, f"{name}: disparity differs from the plain path by {d_err}")
        z_err = ((res.depth_m - ref.depth_m).abs() / ref.depth_m.abs().clamp(min=1e-6)).max().item()
        check(z_err <= 1e-6, f"{name}: depth differs from the plain path by rtol {z_err}")
        del ref
        results[name] = res
        if name == "production":
            check(bool(valid.all()), "production: the fill_invalid contract (all valid) broke")
            y0, x0, bh, bw = BOX
            regions = {"box": ((slice(y0 + 16, y0 + bh - 16), slice(x0 + 16, x0 + bw - 16)),
                               BOX_SHIFT),
                       "background": ((slice(20, -20), slice(80, x0 - BOX_SHIFT + SHIFT - 20)),
                                      SHIFT)}
        else:
            regions = {"plane": ((slice(20, -20), slice(SHIFT + 20, -20)), SHIFT)}
        meds = {}
        for rname, (region, true_d) in regions.items():
            d_core = res.disparity[region][res.confidence[region] > 0]
            check(d_core.numel() > 0.5 * res.disparity[region].numel(),
                  f"{name}: too few confident pixels in the {rname} core")
            med = d_core.median().item()
            tol = 1.0 if name == "production" else 0.5
            check(abs(med - true_d) < tol, f"{name}: {rname} median disparity {med} vs {true_d}")
            z_med = res.depth_m[region][res.confidence[region] > 0].median().item()
            z_true = FOCAL * abs(TX_CM) / 100.0 / true_d
            check(abs(z_med - z_true) < 0.02 * z_true,
                  f"{name}: {rname} median depth {z_med} m vs {z_true} m")
            meds[rname] = (med, true_d, z_med, z_true)
        cloud = pipe.point_cloud(res, cal["Q"])
        check(cloud.shape == (H, W, 3), f"point cloud shape {tuple(cloud.shape)}")
        print(f"pipeline {name}: valid {valid.float().mean().item():.4f} of pixels, matches "
              f"the plain path (disparity max abs err {d_err}); "
              + "; ".join(f"{r} median disparity {m} (true {t}), depth {z:.4f} m (true {zt:.4f} m)"
                          for r, (m, t, z, zt) in meds.items()))

    # -- 5. timing -----------------------------------------------------------
    del results
    frame_ms = {}
    for name, (p, (left_np, right_np), _) in paths.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        pipe = pipes[name]
        for _ in range(WARMUP):
            pipe(left_np, right_np)
        torch.cuda.synchronize()
        frame_ms[name] = ms = cuda_ms(torch, lambda: pipe(left_np, right_np), FRAMES, warmup=0)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        print(f"frame {name}: {ms:.3f} ms/frame, {1e3 / ms:.2f} frames/s ({W}x{H}, D={D}, "
              f"{FRAMES} timed frames after {WARMUP} warm-up; host-to-device copy of the pair "
              f"included), peak device memory {peak_gb:.2f} GB, card {card}")

    def replay(fn, calls):
        return lambda: [fn(*a, **kw) for a, kw in calls]

    prod = recorded["production"]
    for name in [n for names in STAGES.values() for n in names]:
        path = "production" if prod.get(name) else "full_lr_on"
        calls = recorded[path].get(name)
        if not calls:
            continue
        mod = {"im": im, "sgm": sgm, "sgm_cuda": sgm_cuda}[
            next(m for m, names in STAGES.items() if name in names)]
        ms = cuda_ms(torch, replay(getattr(mod, name), calls), 5)
        print(f"stage {name} ({path}, {len(calls)} call(s) of one frame): {ms:.3f} ms "
              f"({100 * ms / frame_ms[path]:.1f}% of the frame)")

    rows = []
    for kname, (src, line, plain_name) in KERNELS.items():
        fn, plain = getattr(sgm_cuda, kname), getattr(sgm_cuda, plain_name)
        for path in ("full_lr_off", "full_lr_on", "production"):
            calls = recorded[path][kname]
            if not calls or (path == "full_lr_on" and recorded["full_lr_off"][kname]):
                continue  # the LR-on search repeats the LR-off one's other launches
            groups = {}
            for a, kw in calls:  # one line per distinct shape, then the frame's total
                groups.setdefault(tuple(tuple(x.shape) for x in a if torch.is_tensor(x)),
                                  []).append((a, kw))
            if len(groups) > 1:
                for shapes, g in groups.items():
                    g_ms = cuda_ms(torch, replay(fn, g), 20, warmup=3)
                    nb = sum(work(kname, a, k)[0] for a, k in g)
                    ops = sum(work(kname, a, k)[1] for a, k in g)
                    b_ms, b_by = bound_ms(nb, ops)
                    print(f"kernel {kname} ({path}) at {shapes}: {g_ms:.4f} ms for {len(g)} "
                          f"launch(es), bound {b_ms:.4f} ms ({b_by})")
            ms = cuda_ms(torch, replay(fn, calls), 20, warmup=3)
            plain_ms = cuda_ms(torch, replay(plain, calls), 2)
            nbytes = sum(work(kname, a, k)[0] for a, k in calls)
            ops = sum(work(kname, a, k)[1] for a, k in calls)
            b_ms, b_by = bound_ms(nbytes, ops)
            library_ms = None
            if kname == "shift_gather":
                # torch.gather computes the same function where off ≤ x and
                # off < max_offset, which holds at every call of the path
                gathers = []
                for a, _ in calls:
                    srcv, off = a[0], a[1]
                    x = torch.arange(off.shape[-1], device=off.device)
                    idx = (x - off.long()).clamp(min=0).expand(srcv.shape).contiguous()
                    gathers.append((srcv, idx))
                library_ms = cuda_ms(torch, lambda: [torch.gather(s_, -1, i_) for s_, i_ in gathers],
                                     20, warmup=3)
            print(f"kernel {kname} ({path}): {ms:.4f} ms per frame ({len(calls)} launches), bound "
                  f"{b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} G operations), "
                  f"plain {plain_ms:.2f} ms"
                  + (f", torch.gather {library_ms:.4f} ms" if library_ms is not None else "")
                  + f", {100 * ms / frame_ms[path]:.1f}% of the frame")
            if path == "production":
                rows.append({
                    "name": kname, "route": "cuda", "source": f"{SOURCES}/{src}",
                    "replaces": f"{REPLACES}:{line}", "launches": launches["production"][kname],
                    "max_abs_err": errs[kname], "parity": "exact", "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
                    "timed_as": "the production frame's launches, replayed on their inputs",
                })
    check(len(rows) == len(KERNELS), "a kernel did not launch on the production path")
    del recorded, prod
    torch.cuda.empty_cache()
    rows += parallel_phases(torch, card)
    torch.cuda.empty_cache()
    rows += script_phases(torch, card)
    check(len(rows) == len(KERNELS) + len(SLICE3_KERNELS) + len(SLICE4_KERNELS),
          "a kernel row is missing")
    print(json.dumps({"kernels": rows}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
