#!/usr/bin/env python3
"""Drive the port's DepthPipeline, its tile-parallel engines, its
measurement scripts, FusedPipeline, the mono-depth networks, calibration
and SfM, the serving daemon, MidasSmall's training, meshes across
processes and the quality evaluations on one CUDA card and check them.

    python3 chip_smoke.py

Three paths run through ``DepthPipeline`` at 1280x720, 320 disparities: the
full search with the LR check off (kept so that its time stays comparable), the
full search with it on (``SGMParams(num_disparities=320)``), and the
production path (``production_preset()``: hier2, R=32 windows, census
arbitration and fill). Then the ``parallel`` package runs on a mesh of four
row tiles on the one card, the engine's ``aggregate``/``_wta`` run
under the kernel impl, the four measurement scripts of
``stereovision_tpu_torch.scripts`` run their variant kernels, and the
options of ``DepthPipeline`` (segmented scans, a processing scale, the
exact speckle filter) and the separable remap run at full width. Phases,
each of which raises (exit code non-zero, no result line) on failure:

1. print the card's name and power limit (nvidia-smi);
2. build the twelve CUDA sources of ``stereovision_tpu_torch/ops/csrc``
   from the checkout, and six of them again with their measurement
   variants, earlier designs and ablations, one nvcc per library, all at
   once;
3. run one frame of each path recording every kernel launch's inputs, then
   replay each recorded launch against the kernel's plain PyTorch version on
   the same inputs: all must be exact; so must ``wta_stats_from_duals`` on
   seeded int16 volumes (the dtype a census with n_bits + P2 > 127 gives);
   each full-search frame must call ``sum_wta_fused`` once (emit ``none``
   with the LR check off, ``hwd`` with it on);
4. run each path through ``DepthPipeline`` with the launch counts set to 0
   just before and read just after: every kernel of the path must have
   launched (``sum_wta`` once a full-search frame, the median three times
   a production frame and once a full-search one), the plain
   ``sgm_cuda.sum_wta`` never; the result must match the path's plain form (``impl="xla"``) on
   the card and recover the synthetic rigs' shifts (a flat rig at 40 px; for
   the production path a background at 40 px and a box at 200 px);
5. time each path (3 warm-up frames, 20 timed, CUDA events), each kernel's
   launches of one frame of each path (replayed on their recorded inputs;
   ``sum_wta``'s on each full-search frame)
   beside their bound, plain version and (for shift_gather)
   ``torch.gather``, and the stages around them; each kernel's replay, and
   ``torch.gather``'s, is timed twice: with events around 20 calls (host
   included) and as 20 replays of a CUDA graph that captured it once (the
   device alone, ``device_ms``); the median (:func:`median_row`) on the
   production and the full frame's launches and on seeded maps of NaN,
   ±inf and ±0, bit for bit against the plain network, timed beside its
   byte bound, its network's floor and the plain network;
6. the exact row-tiled engine (``SGMParams(num_disparities=320)``) on
   ``make_mesh(frame=1, tile=4, devices=["cuda:0"] * 4)``: the sweep
   strategy on 2 flat-rig frames, the pipelined one on 4, each recorded
   (every launch replayed against its plain version: exact) and counted
   (the chain mode must launch T*T times a frame, or (B+T-1)*T times;
   ``sum_wta`` once a tile and frame), and
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
   and ``wta``, each beside its bound (events, and the device alone), the
   host time of one launch with and without a device switch, through the
   wrapper, as the wrapper's launch path was before it read the raw stream
   handle, and of one ``torch.gather`` (:func:`launch_host_us`), of one
   call of each kernel's wrapper (:func:`wrapper_host_us`), and where one
   ``wta_stats_from_duals`` call's host time goes (:func:`wta_stats_host_us`);
10. the measurement scripts at their full shapes (``bench_agg_step``,
   ``bench_wta_variants``, ``bench_rdisp`` at D=128 and 320,
   ``bench_sumwta`` at D=128, 384 and 320), each run with the launch
   counts set to 0 just before and read just after: every variant kernel
   is held against its plain version (exact) and timed beside its bound,
   and its family must have launched; the shipping ``aggregate_dual``
   against the earlier design (``bench_agg_step``'s ``shipping`` variant)
   on axis 0 at the script's (1280, 736, 32) view, the full search's
   columns and an exact-engine slab (D=320): equal outputs, timed in turns
   (earlier, staged, staged, earlier); the shipping
   ``aggregate_dual`` at the engine's shapes (``STAGED_SHAPES``) beside its
   ablations (``bench_cuda.aggregate_staged_variants``: no recurrence, the
   staging and flushing alone, the scan alone), device alone; then ``aggregate_dir``'s
   ``wta_out`` at 720x1280x320 against its plain version, timed beside the
   plain ``aggregate_dir`` launch; then (:func:`redesign_phase`) the
   redesigned ``census_words``, ``cost_volume``, ``wta_stats_from_duals``,
   ``speckle_counts``, ``right_disparity``, ``nearest_valid_lohi`` and
   ``sum_wta`` against their earlier designs (``bench_cuda.census_words_first``,
   ``bench_cuda.cost_volume_first``, ``bench_wta_variants``' ``base``
   variant, ``bench_cuda.speckle_counts_direct``, ``bench_rdisp``'s
   ``in_place`` variant, ``bench_cuda.nearest_valid_lohi_chunks`` and
   ``bench_cuda.sum_wta_first``) on the full search's recorded ``sum_wta``
   launches (LR on: hwd; LR off: none; int8 at 720x1280x320) and seeded
   int16 volumes at that shape, and on
   the production frame's recorded launches (census at 720x1280 and
   240x426, 5x5; the refine stack (960, 1280, 32) and the coarse search
   (240, 426, 107); 720x1280 at k=15, nbins=13 and 240x426 at k=15,
   nbins=6; the LR check at (720, 1280, 32) and (240, 426, 107) int8;
   the fill's 720x1280 along each axis), one seeded ``cost_volume`` launch
   at (720, 1280, 320) and the LR-on full search's ``right_disparity``
   launch at (720, 1280, 320) int16: equal outputs, timed in turns
   (earlier, new, new, earlier), the census, cost, right-disparity and
   sum_wta kernels also with a part taken out (:func:`ablations`), and one ``nearest_valid_lohi``
   launch on a line past 8192 on each axis, exact against its plain
   version;
11. (:func:`pipeline_phases`) the options of ``DepthPipeline`` at full
   width on the production rig: ``agg_wseg=5`` (recorded, replayed,
   counted, against ``impl="xla"``, timed), ``proc_scale=0.5``
   (640x360; the shifts halved, against ``impl="xla"``, timed),
   ``exact_speckle=True`` (the post-pass on the card bit for bit against
   the native flood fill on the host, its rounds, timed), the separable
   remap on a 720p calibration with rotation and distortion (its eight #7
   launches replayed against the plain version, against the exact
   ``remap``, both timed; reported on the #7 row as ``separable_remap``)
   and the autotune (``"auto"`` → the kernel form; both statistics forms
   bit-identical);
12. (:func:`fused_phase`) ``FusedPipeline`` on the production rig at
   ``scale=0.33`` with MidasSmall: its launches replayed and counted, the
   frame against its plain-kernel twin, the covered camera, the shift
   warp, TF32, per-frame and streamed times, stage times, device time and
   synchronising calls;
13. (:func:`mono_models_phase`) the exact MiDaS v2.1 small and DPT-Large
   with seeded weights: the hub-checkpoint path, each against the CPU
   with TF32 off, timed with TF32 off and on with peak memory, each in
   ``FusedPipeline`` (launches replayed and counted, the plain-kernel
   twin, ms per frame, idle share), and ``apps.mono_ai``'s work on a
   1280x720 frame for each of its archs;
14. (:func:`calib_sfm_phase`) calibration and SfM on inputs rendered here:
   twelve 1280x720 stereo pairs of a 9x6 board through the distorted rig,
   detected, calibrated (mono, stereo with fixed intrinsics, universal),
   rectified and checked against the truth and the CPU; the universal
   calibration's ``DepthPipeline(production_preset())`` on a plane at 1.5
   m (launches replayed and counted); a 64-frame sequence through
   ``build_tracks``, the RANSAC pose chain and the landmark BA on 1 and 4
   mesh positions, against each other and the CPU; the mono BA against
   ``calibrate_camera``;
15. (:func:`serve_phase`) ``apps.serve`` at 1280x720, D=320, over PGM
   pairs of the production rig written here: serve's defaults (``hier``,
   refine 32) with ``ping``, ``set``, ``rescale 0.5``, ``stats`` and
   ``shutdown``; ``--sgm-mode prod``; ``--watch --once --batch 8``;
   ``--mode fused --scale 0.33`` with serve's clock fixed: every served
   npz bit for bit against the pipeline called directly; one request of
   each depth mode counted and its launches replayed (exact); the syncs of
   one ``dispatch`` of each mode; ms a request, ``fps``, ``wall_fps``;
16. (:func:`train_phase`) ``models.train_synthetic.main`` at its
   defaults for 20 steps, ms/step, one step on the card against the CPU
   (TF32 off), the checkpoint read back through ``create_model``;
17. (:func:`multihost_phase`) a one-process NCCL group (``psum``, the
   landmark BA of phase 14), then two child processes in a gloo group
   sharing the card (``psum``, ``halo_exchange``, ``sharded_disparity``
   at 720p on two row tiles, the exact engine's sweep and pipelined
   strategies at 720p, D=320 on two row tiles, counted and timed, the
   landmark BA), each against the one-process mesh; a child that fails or
   runs past its time limit fails the phase;
18. (:func:`quality_phase`) the quality evaluations of
   ``stereovision_tpu_torch.scripts`` at 720p, D=320: ``eval_quality``'s
   four scenes in modes ``prod`` and ``full`` (the boxes frames recorded,
   replayed, counted and held against their plain-kernel twins; every
   score within QUALITY_TOL of the JAX reference's CPU scores; ms a
   scene), ``eval_speckle``'s rows at ``hier2`` against the twin's, and
   ``eval_mono``'s rows on the card against the CPU.

Every row of the kernels line has ``device_ms`` (the device alone) beside
``ms`` (host included), ``design`` (the kernel's design: see ``DESIGNS``)
and ``host_us`` (one wrapper call, :func:`wrapper_host_us`).

Each row also has ``served_launches``: its launches in one served request
of each depth mode (phase 15, ``hier`` and ``prod``), and
``quality_boxes_launches``: its launches in phase 18's boxes frame of
each mode (``prod``, ``full``).

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is the card; before that, one ``{"kernels": [...]}`` line,
and before that the script's wall time.
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
# the kernels counted under another name than their wrapper's: the full
# search's own (paths=4: the LR-off and LR-on frames, each exact-engine tile)
# and the median (every engine path): wrapper → (launch-count name, source,
# the TPU kernel's pallas_call, or what it replaces where there is none);
# the plain version is the wrapper's name + "_plain"
NAMED_KERNELS = {"sum_wta_fused": ("sum_wta", "sum_wta.cu", "scripts/bench_sumwta.py:110"),
                 "median_blur": ("median", "median.cu",
                                 "no pallas_call: stereovision_tpu/core/image.py:median_blur "
                                 "(plain jnp)")}
# the median's launches in one frame of each path of phase 3
MEDIAN_LAUNCHES = {"full_lr_off": 1, "full_lr_on": 1, "production": 3}
# the card's rate of float32 min/max, an assumption: half its float32 instruction
# rate (OPS_PER_S counts a multiply-add as two)
MINMAX_PER_S = OPS_PER_S / 4
# the measurement kernels (phase 10): launch-count name → (source, the TPU
# kernel's pallas_call, the row of its script's run that the kernels line
# reports: the shipping kernel's counterpart at the engine's shape)
SLICE4_KERNELS = {
    "aggregate_dual_variants": ("aggregate.cu", "scripts/bench_agg_step.py:216", "shipping"),
    "wta_stats_variants": ("wta_stats.cu", "scripts/bench_wta_variants.py:149", "base"),
    "right_disparity_variants": ("right_disparity.cu", "scripts/bench_rdisp.py:84",
                                 "in_place D={D}"),
}
# each kernel's design, as the kernels line names it: "staged ring" and "row
# grid" are the redesigns of aggregate_dual (a shared-memory ring filled by
# cp.async, a redux min) and shift_gather (a row a grid row, 16-byte
# vectors), "staged pixels" and "column counts" those of
# wta_stats_from_duals (a block's pixels staged by cp.async, G lanes a
# pixel) and speckle_counts (running per-column bin counts, O(k) a pixel),
# "diagonal boxes" right_disparity's (a block's rectangles of 32 planes
# staged by cp.async, each thread walking its right pixel's diagonal there
# with a packed key a plane) and "scans in registers" nearest_valid_lohi's
# (each line's fills as scans over positions held in registers, lo and hi
# written once; axis 0 in tiles of 32 columns by 64 rows, the carries from
# a sweep over valid); "staged rows, 4 pixels a lane" census_words' (a tile
# staged with its replicated border, compares unrolled with constant bit
# positions, a 16-byte store a word plane) and "lanes over x, staged span"
# cost_volume's (a warp's lanes on consecutive pixels, runs of 16
# disparities, the block's output span staged and written in 16-byte
# stores); "staged pixels" is also sum_wta's (wta_stats_from_duals' design
# over four volumes, the int16 sum leaving through a staged output span);
# every other kernel keeps the design it was first ported with
DESIGNS = {"aggregate_dual": "staged ring", "aggregate_dual_chain": "staged ring",
           "sum_wta": "staged pixels",
           "shift_gather": "row grid", "wta_stats_from_duals": "staged pixels",
           "speckle_counts": "column counts", "right_disparity": "diagonal boxes",
           "nearest_valid_lohi": "scans in registers",
           "census_words": "staged rows, 4 pixels a lane",
           "cost_volume": "lanes over x, staged span",
           "median": "staged tile, network in registers"}
# lines past the 8192 that nearest_valid_lohi once refused: shape, axis
LONG_LINES = (((4, 10000), 1), ((9000, 6), 0))
FIRST_DESIGN = "first port"
# the shapes at which phase 10 takes the shipping aggregate_dual apart:
# label, (H, W, D), axis
STAGED_SHAPES = (("the stacked refine", (960, W, 32), 1),
                 ("the coarse search", (H // 3, 426, 107), 1),
                 ("the script's view", (1280, 736, 32), 0),
                 ("the full search, rows", (H, W, D), 1),
                 ("the full search, columns", (H, W, D), 0),
                 ("an exact-engine slab", (H // 4, W, D), 0))
# stages of the production frame, timed by replaying their recorded calls
STAGES = {
    "im": ("remap", "resize"),
    "sgm": ("_coarse_disparity", "_window_shifts", "_refine_two_windows",
            "_census_distance", "_speckle_suppress", "_census_fill"),
    "sgm_cuda": ("st_from_duals", "sum_wta_fused"),
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


def device_ms(fn, label: str):
    """Milliseconds per call of ``fn`` on the device alone (replays of a
    CUDA graph captured once; ``scripts._measure.graph_ms``), or None, with
    the reason printed, where ``fn`` cannot be captured."""
    from stereovision_tpu_torch.scripts._measure import graph_ms

    ms, why = graph_ms(fn)
    if ms is None:
        print(f"device time of {label} not measured: {why}")
    return ms


def fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


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
    if name == "median_blur":
        # the map read once and written once; the network's min/max
        from stereovision_tpu_torch.core import image as im

        k = args[1] if len(args) > 1 else kw.get("ksize", 5)
        return 8 * t.numel(), 2 * len(im._median_pairs(k * k)) * t.numel()
    if name == "sum_wta_fused":
        # four volumes read, the int16 sum (but for emit none) and five maps
        # written; about twelve operations a plane
        emit = kw.get("emit", args[5] if len(args) > 5 else "hwd")
        n = t.numel()
        return (4 * n * t.element_size() + (0 if emit == "none" else 2 * n)
                + 20 * (n // t.shape[-1]), 12 * n)
    raise KeyError(name)


class eager_engine:
    """While active, the stereo engine's public calls run eagerly, each
    through the kernel wrappers (``stereo.sgm.GRAPHS`` at size 0: a replayed
    CUDA graph calls no wrapper)."""

    def __enter__(self):
        from stereovision_tpu_torch.stereo import sgm

        self.graphs, self.size = sgm.GRAPHS, sgm.GRAPHS.size
        self.graphs.resize(0)
        return self

    def __exit__(self, *exc):
        self.graphs.resize(self.size)


class Recorder(eager_engine):
    """While active, the named functions of the given modules record each
    call's arguments (tensors cloned) before running as usual; the engine
    runs eagerly."""

    def __init__(self, torch, targets):
        self.torch = torch
        self.targets = targets  # [(module, name)]
        self.calls = {name: [] for _, name in targets}
        self.saved = []

    def _freeze(self, v):
        return v.clone() if self.torch.is_tensor(v) else v

    def __enter__(self):
        super().__enter__()
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
        super().__exit__(*exc)


def wrapper_of(sgm_cuda, kname):
    """The wrapper behind a launch-count name (the chain mode's is
    aggregate_dual)."""
    return getattr(sgm_cuda, "aggregate_dual" if kname == "aggregate_dual_chain" else kname)


def plain_of(sgm_cuda, kname):
    if kname in NAMED_KERNELS:
        return getattr(sgm_cuda, f"{kname}_plain")
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
            check(len(got) == len(want), f"{kname}: {len(got)} outputs, not {len(want)}")
            for g, w in zip(got, want):
                if g is None or w is None:  # sum_wta_fused with emit none: no volume
                    check(g is None and w is None, f"{kname}: an output is missing")
                    continue
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
    for a tensor off the current device), the whole wrapper, the wrapper as
    it was before its launch path read the raw stream handle (``before``: a
    ``torch.cuda.Stream`` object built and the device looked up through
    ``torch.cuda`` at each launch, every check in full), and one
    ``torch.gather`` call on the same row. Run in the order ABCDEEDCBA; the
    faster of each pair."""
    src = torch.zeros((1, 32), device="cuda")
    off = torch.zeros((1, 32), dtype=torch.int32, device="cuda")
    idx = torch.zeros((1, 32), dtype=torch.int64, device="cuda")
    out = torch.empty_like(src)
    sgm_cuda.shift_gather(src, off, 1)  # loads the kernel's library
    fn, dev = sgm_cuda._fns["shift_gather"], src.device
    args = (src.data_ptr(), off.data_ptr(), out.data_ptr(), 1, 1, 32, 1)

    def switched():
        with torch.cuda.device(dev):
            fn(*args, torch.cuda.current_stream(dev).cuda_stream)

    def before():
        if src.shape[-2:] != off.shape or src.device.type == "cpu":
            raise ValueError("shapes")
        if src.dtype not in (torch.float32, torch.int32) or src.ndim not in (2, 3):
            raise TypeError("src")
        for t, dt, nd in ((src, src.dtype, src.ndim), (off, torch.int32, 2)):
            if (t.device.type != "cuda" or t.dtype != dt or t.ndim != nd
                    or not t.is_contiguous()):
                raise ValueError("check")
        o = torch.empty_like(src)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if dev.index != torch.cuda.current_device():
            raise RuntimeError("off the current device")
        if fn(src.data_ptr(), off.data_ptr(), o.data_ptr(), 1, 1, 32, 1, stream):
            raise RuntimeError("launch")

    forms = {"bare": lambda: fn(*args, torch.cuda.current_stream().cuda_stream),
             "switched": switched, "wrapper": lambda: sgm_cuda.shift_gather(src, off, 1),
             "before": before, "gather": lambda: torch.gather(src, -1, idx)}
    return host_us(torch, forms, n)


def host_us(torch, forms, n: int):
    """Host µs per call of each form (name → callable), each timed twice in
    the order ABC...CBA; the faster of the two."""
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


def wrapper_host_us(torch, sgm_cuda, n: int = 1000):
    """Host µs of one call of each kernel wrapper (all share
    ``sgm_cuda._launch``) on an input too small to keep the card busy: an
    8x32 image or map, an (8, 32, 2) volume."""
    img = torch.zeros((8, 32), device="cuda")
    valid = img > 0
    off = torch.zeros((8, 32), dtype=torch.int32, device="cuda")
    words = torch.zeros((1, 8, 32), dtype=torch.int32, device="cuda")
    vol8 = torch.zeros((8, 32, 2), dtype=torch.int8, device="cuda")
    volf = torch.zeros((8, 32, 2), device="cuda")
    seed = torch.zeros((32, 2), device="cuda")
    forms = {
        "census_words": lambda: sgm_cuda.census_words(img),
        "cost_volume": lambda: sgm_cuda.cost_volume(words, words, 2, 0, 24),
        "aggregate_dual": lambda: sgm_cuda.aggregate_dual(vol8, 8.0, 96.0, axis=1,
                                                          out_dtype=torch.int8),
        "aggregate_dual_chain": lambda: sgm_cuda.aggregate_dual(
            vol8, 8.0, 96.0, boundary=(seed, seed), return_final=True),
        "aggregate_dir": lambda: sgm_cuda.aggregate_dir(volf, 8.0, 96.0),
        "wta_stats_from_duals": lambda: sgm_cuda.wta_stats_from_duals(vol8, vol8),
        "right_disparity": lambda: sgm_cuda.right_disparity(vol8),
        "shift_gather": lambda: sgm_cuda.shift_gather(img, off, 1),
        "speckle_counts": lambda: sgm_cuda.speckle_counts(img, 5, 32.0, 6),
        "nearest_valid_lohi": lambda: sgm_cuda.nearest_valid_lohi(img, valid, img),
        "wta": lambda: sgm_cuda.wta(volf),
        "sum_wta": lambda: sgm_cuda.sum_wta_fused(vol8, vol8, vol8, vol8, emit="none"),
        "median": lambda: sgm_cuda.median_blur(img, 5),
    }
    for f in forms.values():  # builds and loads each library before the clock
        f()
    return host_us(torch, forms, n)


def median_row(torch, sgm_cuda, recorded, frame_ms, launches, errs):
    """The median's row of the kernels line. Each recorded launch of the
    production and the LR-on full frame, and the same maps with a third of
    their pixels seeded with NaN of both signs, ±inf and ±0 at k = 3 and 5,
    against the plain network on the card bit for bit; then each frame's
    launches timed (events, host included; the device alone, one line a
    shape) beside the byte bound, the network's floor at the card's min/max
    rate and the plain network (events and the device alone), and the
    host µs of one call of each on a small map."""
    wname, (kname, src, replaces) = "median_blur", NAMED_KERNELS["median_blur"]
    fn, plain = sgm_cuda.median_blur, sgm_cuda.median_blur_plain

    def bits(t):
        return t.contiguous().view(torch.int32)

    def replay(f, calls):
        return lambda: [f(*a, **kw) for a, kw in calls]

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    special = torch.tensor([float("nan"), -float("nan"), float("inf"), -float("inf"), 0.0, -0.0],
                           device="cuda")
    exact = 0
    for path in ("production", "full_lr_on"):
        calls = recorded[path][wname]
        seeded = []
        for a, _ in calls:
            x = a[0].clone()
            pick = torch.rand(x.shape, generator=gen, device="cuda") < 0.3
            x[pick] = special[torch.randint(0, len(special), x.shape, generator=gen,
                                            device="cuda")][pick]
            seeded += [((x, k), {}) for k in sgm_cuda.MEDIAN_SIZES]
        for a, kw in calls + seeded:
            same = torch.equal(bits(fn(*a, **kw)), bits(plain(*a, **kw)))
            check(same, f"the median differs from the plain network on {path} at "
                        f"{tuple(a[0].shape)}, k={a[1] if len(a) > 1 else kw}")
            exact += 1
    print(f"parity median: {exact} launches bit-exact (the frames' and seeded maps of NaN, "
          f"inf and signed zeros)")
    timed = {}
    for path in ("production", "full_lr_on"):
        calls = recorded[path][wname]
        groups = {}
        for a, kw in calls:
            groups.setdefault(tuple(a[0].shape), []).append((a, kw))
        shapes = {}
        for shape, g in groups.items():
            g_dev = device_ms(replay(fn, g), f"median ({path}) at {shape}")
            nb, ops = tally({wname: g})
            shapes["x".join(map(str, shape))] = g_dev
            print(f"kernel median ({path}) at {shape}: {len(g)} launch(es), device alone "
                  f"{fmt(g_dev)}, bytes bound {nb / MEM_BYTES_PER_S * 1e3:.4f} ms, network "
                  f"floor {ops / MINMAX_PER_S * 1e3:.4f} ms")
        ms = cuda_ms(torch, replay(fn, calls), 20, warmup=3)
        dev = device_ms(replay(fn, calls), f"median ({path})")
        plain_ms = cuda_ms(torch, replay(plain, calls), 5)
        plain_dev = device_ms(replay(plain, calls), f"the plain median ({path})")
        nbytes, ops = tally({wname: calls})
        b_ms, b_by = bound_ms(nbytes, ops)
        floor = ops / MINMAX_PER_S * 1e3
        print(f"kernel median ({path}): {ms:.4f} ms per frame ({len(calls)} launches), device "
              f"alone {fmt(dev)}, bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.1f} MB, "
              f"{ops / 1e9:.2f} G operations), bytes alone "
              f"{nbytes / MEM_BYTES_PER_S * 1e3:.4f} ms, network floor {floor:.4f} ms, plain "
              f"{plain_ms:.3f} ms (device alone {fmt(plain_dev)}), "
              f"{100 * ms / frame_ms[path]:.1f}% of the frame")
        timed[path] = {"ms": ms, "device_ms": dev, "device_ms_by_shape": shapes,
                       "plain_ms": plain_ms, "plain_device_ms": plain_dev, "bound_ms": b_ms,
                       "bound_by": b_by, "bytes_bound_ms": nbytes / MEM_BYTES_PER_S * 1e3,
                       "network_floor_ms": floor, "launches": launches[path][kname]}
    small = torch.zeros((8, 32), device="cuda")
    host = host_us(torch, {"kernel": lambda: fn(small, 5), "plain": lambda: plain(small, 5)},
                   200)
    print(f"median host µs a call on an 8x32 map: kernel {host['kernel']:.2f}, plain network "
          f"{host['plain']:.2f}")
    return {"name": kname, "route": "cuda", "source": f"{SOURCES}/{src}", "replaces": replaces,
            **timed["production"], "max_abs_err": errs[wname], "parity": "exact (bits)",
            "library_ms": None, "design": DESIGNS[kname], "host_us_forms": host,
            "timed_as": "the production frame's launches, replayed on their inputs",
            "full_launch": timed["full_lr_on"]}


def wta_stats_host_us(torch, sgm_cuda, n: int = 1000):
    """Where the host time of one ``wta_stats_from_duals`` call on an
    (8, 32, 2) volume goes: the wrapper, the wrapper as it was before
    (``earlier``: five index views and a dtype view of the maps, a
    ``data_ptr`` call each), and its parts: the checks, the maps'
    allocation, the views either way, and the launch alone (the C entry on
    the current stream). Host µs a call, each form timed twice."""
    vol = torch.zeros((8, 32, 2), dtype=torch.int8, device="cuda")
    maps = torch.empty((5, 8, 32), device="cuda")
    sgm_cuda.wta_stats_from_duals(vol, vol)  # loads the kernel's library
    fn = sgm_cuda._fns["wta_stats"]
    p, step = maps.data_ptr(), 4 * 8 * 32
    args = (vol.data_ptr(), vol.data_ptr(), p, p + step, p + 2 * step, p + 3 * step,
            p + 4 * step, 8 * 32, 2, 2, 1)

    def earlier():
        D = vol.shape[-1]
        if vol.device.type == "cpu":
            raise ValueError("cpu")
        sgm_cuda._check_planes("wta_stats_from_duals", D)
        if vol.dtype not in (torch.int8, torch.int16):
            raise TypeError("dtype")
        sgm_cuda._check(vol, "hf", vol.dtype, 3)
        sgm_cuda._check(vol, "hb", vol.dtype, 3)
        if vol.shape != vol.shape:
            raise ValueError("shapes")
        H, W, _ = vol.shape
        m = torch.empty((5, H, W), dtype=torch.float32, device=vol.device)
        best, idx, cm, cp, comp = m[0], m[1].view(torch.int32), m[2], m[3], m[4]
        sgm_cuda._launch("wta_stats", vol.device, vol.data_ptr(), vol.data_ptr(), best.data_ptr(),
                         idx.data_ptr(), cm.data_ptr(), cp.data_ptr(), comp.data_ptr(), H * W, D,
                         D, vol.element_size())
        return best, idx, cm, cp, comp

    def checks():
        sgm_cuda._check_planes("wta_stats_from_duals", 2)
        sgm_cuda._check(vol, "hf", vol.dtype, 3)
        sgm_cuda._check(vol, "hb", vol.dtype, 3)
        return vol.shape != vol.shape

    forms = {
        "wrapper": lambda: sgm_cuda.wta_stats_from_duals(vol, vol),
        "earlier": earlier,
        "checks": checks,
        "empty": lambda: torch.empty((5, 8, 32), dtype=torch.float32, device=vol.device),
        "index_views": lambda: (maps[0], maps[1].view(torch.int32), maps[2], maps[3], maps[4]),
        "unbind_views": lambda: maps.unbind(0)[1].view(torch.int32),
        "launch": lambda: fn(*args, torch.cuda.current_stream().cuda_stream),
    }
    return host_us(torch, forms, n)


def parallel_phases(torch, card: str):
    """Phases 6-9; returns the kernels-line rows of the three kernels and
    the host µs of a launch (:func:`launch_host_us`, :func:`wrapper_host_us`)."""
    from stereovision_tpu_torch import parallel
    from stereovision_tpu_torch.ops import sgm_cuda
    from stereovision_tpu_torch.stereo import SGMParams, production_preset, sgm

    names = list(KERNELS) + list(NAMED_KERNELS) + ["aggregate_dir", "wta"]
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
            "right_disparity", "shift_gather", "speckle_counts", "sum_wta")
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
        check(counts["sum_wta"] == B * TILES,
              f"{sname}: {counts['sum_wta']} sum_wta launches, not one a tile ({B * TILES})")
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
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        ms = cuda_ms(torch, lambda: fn(lefts[:B], rights[:B], p, mesh), 3) / B
        own = (torch.cuda.max_memory_allocated() - held) / 1e9
        b_ms, b_by = bound_ms(nb, ops)
        print(f"frame exact {sname}: {ms:.3f} ms/frame over {B} frames ({W}x{H}, D={D}, "
              f"{TILES} row tiles sharing one card: not a scaling number; host-to-device copy "
              f"included), its kernels' bound {b_ms / B:.4f} ms/frame ({b_by}), peak device "
              f"memory of the run {own:.2f} GB (above the {held / 1e9:.2f} GB this script "
              f"holds), card {card}")
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
    one_dev = device_ms(replay(sgm_cuda.aggregate_dual, one), "one chain launch")
    b1 = bound_ms(*tally({"aggregate_dual_chain": one}))
    print(f"kernel aggregate_dual_chain: one launch on a {tuple(one[0][0][0].shape)} slab with "
          f"cost_b: {one_ms:.4f} ms, device alone {fmt(one_dev)}, bound {b1[0]:.4f} ms "
          f"({b1[1]})")
    for a, kw in vol_calls["aggregate_dir"]:
        l_ms = cuda_ms(torch, replay(sgm_cuda.aggregate_dir, [(a, kw)]), 5, warmup=1)
        lb = bound_ms(*tally({"aggregate_dir": [(a, kw)]}))
        print(f"kernel aggregate_dir axis {kw.get('axis')} reverse {kw.get('reverse', False)} "
              f"acc {kw.get('acc') is not None}: {l_ms:.4f} ms, bound {lb[0]:.4f} ms ({lb[1]})")
    for kname, (fn, calls, n_launches, how) in timed.items():
        ms = cuda_ms(torch, replay(fn, calls), 5 if kname == "aggregate_dir" else 20, warmup=1)
        dev = device_ms(replay(fn, calls), kname)
        plain_ms = cuda_ms(torch, replay(plain_of(sgm_cuda, kname), calls), 1, warmup=0)
        nbytes, ops = tally({kname: calls})
        b_ms, b_by = bound_ms(nbytes, ops)
        print(f"kernel {kname}: {ms:.4f} ms for {len(calls)} launches ({how}), device alone "
              f"{fmt(dev)}, bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.1f} MB, "
              f"{ops / 1e9:.2f} G operations), plain {plain_ms:.2f} ms")
        src, line, _ = SLICE3_KERNELS[kname]
        rows.append({
            "name": kname, "route": "cuda", "source": f"{SOURCES}/{src}",
            "replaces": f"{REPLACES}:{line}", "launches": n_launches,
            "max_abs_err": errs[kname], "parity": "exact", "ms": ms, "device_ms": dev,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "design": DESIGNS.get(kname, FIRST_DESIGN), "timed_as": how,
        })
    rows[0]["launches_sweep"] = runs["sweep"][2]["aggregate_dual_chain"]
    rows[0]["one_launch_ms"], rows[0]["one_launch_device_ms"] = one_ms, one_dev
    us = launch_host_us(torch, sgm_cuda)
    print(f"launch host time: {us['bare']:.2f} µs bare, {us['switched']:.2f} µs under "
          f"torch.cuda.device, {us['wrapper']:.2f} µs through the shift_gather wrapper "
          f"(on the current device: no switch; {us['before']:.2f} µs through the wrapper's "
          f"launch path before the raw stream handle), {us['gather']:.2f} µs a torch.gather "
          f"call on the same row, card {card}")
    per_kernel = wrapper_host_us(torch, sgm_cuda)
    print("wrapper host time a launch (8x32 inputs): "
          + ", ".join(f"{k} {v:.2f} µs" for k, v in per_kernel.items()) + f", card {card}")
    wta_us = wta_stats_host_us(torch, sgm_cuda)
    print("wta_stats_from_duals host time, taken apart (8x32x2 int8): "
          + ", ".join(f"{k} {v:.2f} µs" for k, v in wta_us.items()) + f", card {card}")
    return rows, {"shift_gather": us, "wrappers": per_kernel, "wta_stats_from_duals": wta_us}


def script_phases(torch, card: str):
    """Phase 10; returns the kernels-line rows of three measurement kernel
    families, and {the fourth's (sum_wta's) name: its script's
    device_ms by variant} (sum_wta's row is the full search's)."""
    from stereovision_tpu_torch.ops import bench_cuda, sgm_cuda
    from stereovision_tpu_torch.scripts import (bench_agg_step, bench_rdisp, bench_sumwta,
                                                bench_wta_variants)

    runs = {
        "aggregate_dual_variants": lambda: bench_agg_step.run(),
        "wta_stats_variants": lambda: bench_wta_variants.run(),
        "right_disparity_variants": lambda: bench_rdisp.run(ds=(128, D)),
        "sum_wta": lambda: bench_sumwta.run(ds=(128, 384, D)),
    }
    rows, script_rows = [], {}
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
        if kname not in SLICE4_KERNELS:  # sum_wta: its row is the full search's
            script_rows[kname] = {r["variant"]: r["device_ms"] for r in results}
            continue
        src, replaces, label = SLICE4_KERNELS[kname]
        label = label.format(D=D)
        pick = next(r for r in results if r["variant"] == label)
        rows.append({
            "name": kname, "route": "cuda", "source": f"{SOURCES}/{src}", "replaces": replaces,
            "launches": counts[kname], "max_abs_err": max(r["max_abs_err"] for r in kernel_rows),
            "parity": "exact", "ms": pick["ms"], "device_ms": pick["device_ms"],
            "plain_ms": pick["plain_ms"], "bound_ms": pick["bound_ms"],
            "bound_by": pick["bound_by"], "library_ms": None, "design": FIRST_DESIGN,
            "timed_as": f"the {label} row of the script's run (20 launches after 3 warm-up)",
        })

    # the shipping aggregate_dual against the earlier design (the variants'
    # "shipping") on axis 0, in turns: the script's (1280, 736, 32) view, and
    # the full search's columns and an exact-engine slab at D=320
    pa = (bench_agg_step.P1, bench_agg_step.P2)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ab_all = {}
    for label, x in (("the script's view", bench_agg_step.variant_input(
                          bench_agg_step.make_cost(torch.device("cuda")), "shipping")),
                     ("the full search, columns", torch.randint(
                         0, 61, (H, W, D), dtype=torch.int8, device="cuda", generator=gen)),
                     ("an exact-engine slab", torch.randint(
                         0, 61, (H // 4, W, D), dtype=torch.int8, device="cuda", generator=gen))):
        forms = {"earlier": lambda x=x: bench_cuda.aggregate_dual_variants(x, "shipping", *pa,
                                                                            bench_agg_step.BS),
                 "staged": lambda x=x: sgm_cuda.aggregate_dual(x, *pa, axis=0,
                                                               out_dtype=torch.int8)}
        got, want = forms["staged"](), forms["earlier"]()
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"the staged aggregate_dual differs from the earlier design at {label}")
        del got, want
        ab = {name: [] for name in forms}
        for name in ("earlier", "staged", "staged", "earlier"):
            ab[name].append((cuda_ms(torch, forms[name], 20, warmup=3),
                             device_ms(forms[name], f"aggregate_dual {name} at {label}")))
        print(f"aggregate_dual at {label} {tuple(x.shape)} int8, axis 0, in turns (earlier, "
              f"staged, staged, earlier), equal outputs: " + "; ".join(
                  f"{name} " + ", ".join(f"{ms:.4f} ms (device alone {fmt(dev)})" for ms, dev in v)
                  for name, v in ab.items()) + f", card {card}")
        ab_all[label] = ab
        del x
    agg_row = next(r for r in rows if r["name"] == "aggregate_dual_variants")
    agg_row["staged_ab"] = ab_all

    # which part of the shipping aggregate_dual holds its time: the kernel
    # with its recurrence, its scan or its staging and flushing taken out, on
    # seeded costs at the shapes the engine gives it (device alone)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    table = {}
    for label, shape, axis in STAGED_SHAPES:
        cost = torch.randint(0, 61, shape, dtype=torch.int8, device="cuda", generator=gen)
        forms = {"full": lambda: sgm_cuda.aggregate_dual(cost, 8.0, 96.0, axis=axis,
                                                         out_dtype=torch.int8)}
        forms.update({f: (lambda f=f: bench_cuda.aggregate_staged_variants(cost, f, axis=axis))
                      for f in bench_cuda.STAGED_FORMS})
        got = forms["no_recurrence"]()
        check(all(torch.equal(g, w) for g, w in
                  zip(got, bench_cuda.aggregate_staged_variants_plain(cost, "no_recurrence"))),
              "the staged no_recurrence ablation differs from its plain version")
        table[label] = {f: device_ms(fn, f"staged {f} at {label}") for f, fn in forms.items()}
        b_ms = bound_ms(*work("aggregate_dual", (cost, 8.0, 96.0, axis, torch.int8), {}))[0]
        print(f"aggregate_dual (staged) at {label} {shape} axis {axis}, int8, device alone: "
              + ", ".join(f"{f} {fmt(ms)}" for f, ms in table[label].items())
              + f"; bound {b_ms:.4f} ms, card {card}")
        del cost, got
    agg_row["staged_ablations"] = table

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
    return rows, script_rows


def launch_label(kname: str, a, kw) -> str:
    """A redesigned kernel's launch by its shape and the arguments that
    choose its work."""
    if kname == "right_disparity":
        return f"{tuple(a[0].shape)} {str(a[0].dtype).removeprefix('torch.')}"
    if kname == "nearest_valid_lohi":
        return f"{tuple(a[0].shape)} axis {kw.get('axis', a[3] if len(a) > 3 else 1)}"
    if kname == "census_words":
        return f"{tuple(a[0].shape)} {a[1]}x{a[2]}"
    if kname == "cost_volume":
        nw, h, wd = a[0].shape
        return f"({h}, {wd}, {a[2]}) nw={nw} min_d={a[3]}"
    if kname == "speckle_counts":
        return f"{tuple(a[0].shape)} k={a[1]} nbins={a[3]}"
    if kname == "sum_wta_fused":
        return (f"{tuple(a[0].shape)} {str(a[0].dtype).removeprefix('torch.')} "
                f"{kw.get('emit', 'hwd')}")
    return str(tuple(a[0].shape))


def seeded_cost_launch(torch, sgm_cuda):
    """One cost_volume launch at the full search's (720, 1280, 320): the 5x5
    census of the seeded flat pair, min_d 0, max_cost 24."""
    cl, cr = (sgm_cuda.census_words(torch.as_tensor(img, device="cuda"), 5, 5)
              for img in flat_pair())
    return (cl, cr, D, 0, 24), {}


def ablations(torch, kname: str, a, label: str):
    """The device time of each ablation of the shipping census_words (at
    5x5), cost_volume (at nw = 1), right_disparity or sum_wta kernel on one
    recorded launch's inputs (``bench_cuda.census_words_ablations``,
    ``cost_volume_ablations``, ``right_disparity_ablations``,
    ``sum_wta_ablations``), each defined one exact against its plain
    version; None for another launch."""
    from stereovision_tpu_torch.ops import bench_cuda

    if kname == "right_disparity":
        return {form: device_ms(lambda form=form: bench_cuda.right_disparity_ablations(
                    *a[:1], form, *a[1:2]), f"{form} at {label}")
                for form in bench_cuda.RDISP_ABLATIONS}
    if kname == "sum_wta_fused":
        got = bench_cuda.sum_wta_ablations(*a[:4], "no_store")
        want = bench_cuda.sum_wta_ablations_plain(*a[:4], "no_store")
        check(all(torch.equal(g, w) for g, w in zip(got[1:], want[1:])),
              f"the no_store ablation's statistics differ from the plain ones at {label}")
        return {form: device_ms(lambda form=form: bench_cuda.sum_wta_ablations(*a[:4], form),
                                f"{form} at {label}")
                for form in bench_cuda.SUM_ABLATIONS}
    if kname == "census_words" and tuple(a[1:3]) == (5, 5):
        fn, plain, forms, args = (bench_cuda.census_words_ablations,
                                  bench_cuda.census_words_ablations_plain,
                                  bench_cuda.CENSUS_ABLATIONS, a[:1])
    elif kname == "cost_volume" and a[0].shape[0] == 1:
        fn, plain, forms, args = (bench_cuda.cost_volume_ablations,
                                  bench_cuda.cost_volume_ablations_plain,
                                  bench_cuda.COST_ABLATIONS, a)
    else:
        return None
    out = {}
    for form in forms:
        if form == "direct" and a[2] % 16:
            continue
        want = plain(*args, form)
        if want is not None:
            check(torch.equal(fn(*args, form), want),
                  f"the {form} ablation differs from its plain version at {label}")
        out[form] = device_ms(lambda form=form: fn(*args, form), f"{form} at {label}")
    return out


def redesign_phase(torch, card: str, calls):
    """The end of phase 10: each redesigned kernel against its earlier design
    on the production frame's recorded launches, the full search's for
    ``sum_wta`` (wrapper name → [(args, kwargs)]; each distinct launch
    once, see :func:`launch_label`): both
    exact against the plain version, then timed in turns (earlier, new,
    new, earlier; events and the device alone), census_words,
    cost_volume, right_disparity and sum_wta also with a part taken out
    (:func:`ablations`); and ``nearest_valid_lohi`` on lines past 8192
    (``LONG_LINES``), exact. Returns {wrapper name: {launch: the turns'
    (ms, device_ms) by design, the bound and the ablations' device_ms}}."""
    from stereovision_tpu_torch.ops import bench_cuda, sgm_cuda

    earlier = {
        "wta_stats_from_duals": lambda hf, hb, d_valid=None: bench_cuda.wta_stats_variants(
            hf, hb, "base", d_valid),
        "right_disparity": lambda s, d_valid=None: bench_cuda.right_disparity_variants(
            s, "in_place", d_valid),
        "nearest_valid_lohi": bench_cuda.nearest_valid_lohi_chunks,
        "speckle_counts": bench_cuda.speckle_counts_direct,
        "census_words": bench_cuda.census_words_first,
        "cost_volume": bench_cuda.cost_volume_first,
        "sum_wta_fused": bench_cuda.sum_wta_first,
    }
    table = {}
    for kname, kcalls in calls.items():
        forms = {"earlier": earlier[kname], "new": getattr(sgm_cuda, kname)}
        table[kname] = {}
        for a, kw in kcalls:
            label = launch_label(kname, a, kw)
            if label in table[kname]:
                continue
            want = plain_of(sgm_cuda, kname)(*a, **kw)
            want = want if isinstance(want, tuple) else (want,)
            for name, fn in forms.items():
                got = fn(*a, **kw)
                got = got if isinstance(got, tuple) else (got,)
                check(len(got) == len(want) and all(
                    (g is None and w is None) or (g is not None and w is not None
                                                  and g.dtype == w.dtype and torch.equal(g, w))
                    for g, w in zip(got, want)),
                    f"{kname} ({name} design) differs from its plain version at {label}")
            del got, want
            turns = {"earlier": [], "new": []}
            for name in ("earlier", "new", "new", "earlier"):
                def call(fn=forms[name]):
                    return fn(*a, **kw)
                turns[name].append((cuda_ms(torch, call, 20, warmup=3),
                                    device_ms(call, f"{kname} {name} at {label}")))
            b_ms, b_by = bound_ms(*work(kname, a, kw))
            print(f"redesigned {kname} at {label}, in turns (earlier, new, new, earlier), "
                  "equal outputs: " + "; ".join(
                      f"{name} " + ", ".join(f"{ms:.4f} ms (device alone {fmt(dev)})"
                                             for ms, dev in v) for name, v in turns.items())
                  + f"; bound {b_ms:.4f} ms ({b_by}), card {card}")
            table[kname][label] = {**turns, "bound_ms": b_ms, "bound_by": b_by}
            abl = ablations(torch, kname, a, f"{kname} at {label}")
            if abl:
                table[kname][label]["ablations"] = abl
                print(f"{kname} at {label} with a part taken out, device alone: "
                      + ", ".join(f"{f} {fmt(ms)}" for f, ms in abl.items())
                      + f" (the whole kernel {fmt(turns['new'][0][1])}), card {card}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for shape, axis in LONG_LINES:
        d = torch.rand(shape, generator=gen, device="cuda") * 64
        v = torch.rand(shape, generator=gen, device="cuda") < 0.002
        v[1] = False
        v[:, 2] = False
        up = torch.rand(shape, generator=gen, device="cuda") * 64
        got = sgm_cuda.nearest_valid_lohi(d, v, up, axis)
        want = sgm_cuda.nearest_valid_lohi_plain(d, v, up, axis)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"nearest_valid_lohi differs from its plain version on {shape} along axis {axis}")
        print(f"nearest_valid_lohi on {shape} along axis {axis} (lines of {shape[axis]}): exact "
              f"against its plain version, card {card}")
    return table

# the calibration of phase 11d: a small relative rotation and barrel
# distortion, rectified by the port's stereo_rectify (alpha 0)
SEP_ROTATION = (0.002, 0.004, -0.001)
SEP_DIST = (-0.05, 0.01, 0.0, 0.0, 0.0)
SEP_T_CM = (TX_CM, 0.02, 0.01)


def pipeline_phases(torch, card: str, cal, planes, prod_launches, prod_ms):
    """Phase 11, the options of ``DepthPipeline`` and the separable remap at
    full width on the production rig (``two_plane_pair``):

    a. ``production_preset()`` with ``agg_wseg=5``: the refine's horizontal
       pair restarts every 256 columns (#4 on the segmented view), the
       426-wide coarse search takes no segments; every launch of a frame
       replayed against its plain version (exact), the frame counted (the
       production frame's kernels and counts), against ``impl="xla"`` on
       the card, timed;
    b. ``proc_scale=0.5``: the 1280x720 rig processed at 640x360; the
       processing size, the shifts halved, the depths kept, against
       ``impl="xla"`` on the card, timed;
    c. ``exact_speckle=True``: the post-pass on the card against the
       native flood fill on the host on the same pre-pass disparity (bit
       for bit), the labelling's rounds, the post-pass and the frame timed,
       against ``impl="xla"`` on the card;
    d. the separable remap (``remap_separable``, four #7 launches an image)
       on a 720p calibration with rotation and distortion: each launch
       against ``shift_gather_plain`` (exact), the result against the exact
       ``remap`` (the reference test's tolerances), both forms timed;
    e. the autotune: ``tune_stats_impl`` resolves "auto" to the kernel form,
       both statistics formulations give bit-identical statistics at the
       refine's recorded launch and the same production frame, and
       ``timed_best`` times them.

    Returns the separable remap's entry of the #7 row."""
    import dataclasses

    from stereovision_tpu_torch.core import geometry as geom
    from stereovision_tpu_torch.core import image as im
    from stereovision_tpu_torch.ops import native, sgm_cuda
    from stereovision_tpu_torch.pipeline import DepthPipeline
    from stereovision_tpu_torch.stereo import autotune, production_preset, sgm
    from stereovision_tpu_torch.stereo import speckle_ccl

    left_np, right_np = planes
    targets = [(sgm_cuda, name) for name in KERNELS]

    def against_plain(name, pipe, params, shape, **options):
        res = pipe(left_np, right_np)
        ref = DepthPipeline(cal, dataclasses.replace(params, impl="xla"), min_depth=0.2,
                            max_depth=4.0, **options)(left_np, right_np)
        torch.cuda.synchronize()
        check(tuple(res.disparity.shape) == shape, f"{name}: shape {tuple(res.disparity.shape)}")
        sentinel = params.min_disparity - 1
        check(torch.equal(res.disparity > sentinel, ref.disparity > sentinel),
              f"{name}: valid differs from the plain path")
        d_err = (res.disparity - ref.disparity).abs().max().item()
        check(d_err <= 1e-4, f"{name}: disparity differs from the plain path by {d_err}")
        z_err = ((res.depth_m - ref.depth_m).abs()
                 / ref.depth_m.abs().clamp(min=1e-6)).max().item()
        check(z_err <= 1e-6, f"{name}: depth differs from the plain path by rtol {z_err}")
        return res, d_err

    def frame_time(name, pipe):
        for _ in range(WARMUP):
            pipe(left_np, right_np)
        torch.cuda.synchronize()
        ms = cuda_ms(torch, lambda: pipe(left_np, right_np), FRAMES, warmup=0)
        print(f"frame {name}: {ms:.3f} ms/frame, {1e3 / ms:.2f} frames/s ({FRAMES} timed frames "
              f"after {WARMUP} warm-up; the unsegmented production frame {prod_ms:.3f} ms in "
              f"phase 5), card {card}")
        return ms

    def medians(name, res, scale):
        y0, x0, bh, bw = (int(v * scale) for v in BOX)
        m = int(16 * scale)
        regions = {"box": ((slice(y0 + m, y0 + bh - m), slice(x0 + m, x0 + bw - m)),
                           BOX_SHIFT * scale),
                   "background": ((slice(m, -m), slice(int(80 * scale),
                                                       x0 - int((BOX_SHIFT - SHIFT) * scale) - m)),
                                  SHIFT * scale)}
        for rname, (region, true_d) in regions.items():
            ok = res.confidence[region] > 0
            check(ok.float().mean().item() > 0.5, f"{name}: too few confident {rname} pixels")
            med = res.disparity[region][ok].median().item()
            z_med = res.depth_m[region][ok].median().item()
            z_true = FOCAL * abs(TX_CM) / 100.0 / (true_d / scale)
            check(abs(med - true_d) < 1.0, f"{name}: {rname} median disparity {med} vs {true_d}")
            check(abs(z_med - z_true) < 0.02 * z_true,
                  f"{name}: {rname} median depth {z_med} m vs {z_true} m")
            print(f"{name}: {rname} median disparity {med} (true {true_d}), depth {z_med:.4f} m "
                  f"(true {z_true:.4f} m)")

    # -- 11a. segmented horizontal scans --------------------------------------
    p_seg = dataclasses.replace(production_preset(), agg_wseg=5)
    pipe = DepthPipeline(cal, p_seg, min_depth=0.2, max_depth=4.0)
    with Recorder(torch, targets) as rec:
        pipe(left_np, right_np)
        torch.cuda.synchronize()
    duals = [tuple(a[0].shape) for a, _ in rec.calls["aggregate_dual"]]
    seg_view, coarse = (5 * (H + H // 3), W // 5, 32), (H // 3, W // 3, -(-D // 3))
    check(seg_view in duals and coarse in duals,
          f"agg_wseg=5: aggregate_dual at {duals}, not the refine's segmented view "
          f"{seg_view} and the coarse search's {coarse}")
    parity(torch, sgm_cuda, rec.calls, "production agg_wseg=5")
    del rec
    sgm_cuda.reset_launch_counts()
    pipe(left_np, right_np)
    torch.cuda.synchronize()
    counts = {k: n for k, n in sgm_cuda.launch_counts().items() if k in prod_launches}
    print(f"launches in one agg_wseg=5 production frame: {counts}")
    check(counts == prod_launches,
          f"agg_wseg=5: launches {counts}, not the production frame's {prod_launches}")
    _, d_err = against_plain("agg_wseg=5", pipe, p_seg, (H, W))
    print(f"pipeline production agg_wseg=5: matches the plain path (disparity max abs err {d_err}); "
          f"aggregate_dual at {sorted(set(duals))}")
    seg_ms = frame_time("production agg_wseg=5", pipe)

    # -- 11b. proc_scale -------------------------------------------------------
    p = production_preset()
    pipe = DepthPipeline(cal, p, min_depth=0.2, max_depth=4.0, proc_scale=0.5)
    check(pipe.proc_size == (W // 2, H // 2), f"proc_scale=0.5: proc_size {pipe.proc_size}")
    sgm_cuda.reset_launch_counts()
    pipe(left_np, right_np)
    torch.cuda.synchronize()
    counts = {k: n for k, n in sgm_cuda.launch_counts().items() if k in prod_launches}
    print(f"launches in one proc_scale=0.5 production frame: {counts}")
    for k in ("census_words", "cost_volume", "aggregate_dual", "wta_stats_from_duals",
              "right_disparity", "shift_gather", "speckle_counts", "nearest_valid_lohi"):
        check(counts[k] > 0, f"proc_scale=0.5: kernel {k} was not launched")
    res, d_err = against_plain("proc_scale=0.5", pipe, p, (H // 2, W // 2), proc_scale=0.5)
    print(f"pipeline production proc_scale=0.5: {pipe.size} processed at {pipe.proc_size}, "
          f"focal {pipe.focal:.4f} px, matches the plain path (disparity max abs err {d_err})")
    medians("proc_scale=0.5", res, 0.5)
    half_ms = frame_time("production proc_scale=0.5", pipe)

    # -- 11c. the exact speckle post-pass --------------------------------------
    pipe = DepthPipeline(cal, p, min_depth=0.2, max_depth=4.0, exact_speckle=True)
    check(pipe.params.speckle_window_size == 0, "exact_speckle: the engine kept its speckle stage")
    pre = pipe._run(left_np, right_np)[0]
    sp = pipe._speckle_params
    d_dev, v_dev = sgm.exact_speckle_postpass(pre, sp)
    d_nat, v_nat = sgm.exact_speckle_postpass(pre.cpu(), sp, impl="native")
    torch.cuda.synchronize()
    check(d_dev.is_cuda and torch.equal(d_dev.cpu(), d_nat) and torch.equal(v_dev.cpu(), v_nat),
          "exact_speckle: the post-pass on the card differs from the native flood fill")
    _, rounds = speckle_ccl.label_components_counted(pre, sp.speckle_range)
    removed = int((v_dev != (pre > sp.min_disparity - 1)).sum())
    post_ms = cuda_ms(torch, lambda: sgm.exact_speckle_postpass(pre, sp), 10, warmup=2)
    t0 = time.perf_counter()
    native.filter_speckles(pre.cpu().numpy(), sp.min_disparity - 1.0, sp.speckle_window_size,
                           sp.speckle_range)
    native_ms = (time.perf_counter() - t0) * 1e3
    res, d_err = against_plain("exact_speckle", pipe, p, (H, W), exact_speckle=True)
    print(f"exact speckle post-pass at {H}x{W}: equal to the native flood fill, {removed} pixels "
          f"removed, {rounds} labelling rounds, {post_ms:.3f} ms on the card (events around "
          f"10 calls, one host sync a round), the native flood fill {native_ms:.3f} ms on the "
          f"host; the frame matches the plain path (disparity max abs err {d_err})")
    speckle_ms = frame_time("production exact_speckle", pipe)

    # -- 11d. the separable remap -----------------------------------------------
    K = torch.tensor([[FOCAL, 0, (W - 1) / 2], [0, FOCAL, (H - 1) / 2], [0, 0, 1]],
                     dtype=torch.float64)
    dist = torch.tensor(SEP_DIST, dtype=torch.float64)
    R = geom.rodrigues(torch.tensor(SEP_ROTATION, dtype=torch.float64))
    R1, R2, P1, P2, _ = geom.stereo_rectify(K, dist, K, dist, (W, H), R,
                                            torch.tensor(SEP_T_CM, dtype=torch.float64), alpha=0.0)
    maps, preps = [], []
    for Rr, Pr in ((R1, P1), (R2, P2)):
        mx, my = geom.init_undistort_rectify_map(*(t.cuda() for t in (K, dist, Rr, Pr)), (W, H))
        prep = im.prepare_separable_remap(mx, my)
        check(prep is not None, "the 720p calibration's maps do not take the separable remap")
        my_adj, valid, rx, ry = prep
        maps.append((mx, my))
        preps.append((torch.from_numpy(my_adj).cuda(), torch.from_numpy(valid).cuda(), rx, ry))
    imgs = [torch.from_numpy(a).cuda() for a in (left_np, right_np)]

    def separable():
        return [im.remap_separable(img, mx, my_adj, valid, rx, ry)
                for img, (mx, _), (my_adj, valid, rx, ry) in zip(imgs, maps, preps)]

    def exact():
        return [im.remap(img, mx, my) for img, (mx, my) in zip(imgs, maps)]

    with Recorder(torch, [(sgm_cuda, "shift_gather")]) as rec:
        got = separable()
        torch.cuda.synchronize()
    calls = rec.calls["shift_gather"]
    err = parity(torch, sgm_cuda, {"shift_gather": calls}, "remap_separable")
    sgm_cuda.reset_launch_counts()
    separable()
    torch.cuda.synchronize()
    n_launch = sgm_cuda.launch_counts()["shift_gather"]
    check(n_launch == 8 == len(calls), f"remap_separable: {n_launch} shift_gather launches, not 8")
    for g, w in zip(got, exact()):
        check(torch.equal(g == 0, w == 0), "remap_separable zeroes other pixels than remap")
        inside = w != 0
        med = (g - w).abs()[inside].median().item()
        check(med < 0.2, f"remap_separable: median abs difference {med} from remap")
    ranges = [(rx, ry) for *_, rx, ry in preps]
    sep_ms = cuda_ms(torch, separable, 20, warmup=3)
    sep_dev = device_ms(separable, "remap_separable")
    exact_ms = cuda_ms(torch, exact, 20, warmup=3)
    exact_dev = device_ms(exact, "remap")

    def replay(fn):
        return lambda: [fn(*a, **kw) for a, kw in calls]

    k_ms = cuda_ms(torch, replay(sgm_cuda.shift_gather), 20, warmup=3)
    k_dev = device_ms(replay(sgm_cuda.shift_gather), "shift_gather (remap_separable)")
    k_plain = cuda_ms(torch, replay(sgm_cuda.shift_gather_plain), 5)
    gathers = []
    for (srcv, off, _), _ in calls:
        x = torch.arange(off.shape[-1], device=off.device)
        gathers.append((srcv, (x - off.long()).clamp(min=0).expand(srcv.shape).contiguous()))

    def gather_all():
        return [torch.gather(s_, -1, i_) for s_, i_ in gathers]

    lib_ms = cuda_ms(torch, gather_all, 20, warmup=3)
    lib_dev = device_ms(gather_all, "torch.gather (remap_separable)")
    nbytes, ops = tally({"shift_gather": calls})
    b_ms, b_by = bound_ms(nbytes, ops)
    print(f"remap_separable at {W}x{H} (ranges {ranges}): {sep_ms:.4f} ms for both images, "
          f"device alone {fmt(sep_dev)}; the exact remap {exact_ms:.4f} ms, device alone "
          f"{fmt(exact_dev)}; its 8 shift_gather launches {k_ms:.4f} ms, device alone "
          f"{fmt(k_dev)}, bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.1f} MB), plain "
          f"{k_plain:.3f} ms, torch.gather {lib_ms:.4f} ms (device alone {fmt(lib_dev)}), "
          f"card {card}")

    # -- 11e. the autotune ---------------------------------------------------------
    auto = production_preset()
    check(auto.stats_impl == "auto" and autotune.tune_stats_impl(auto).stats_impl == "pallas",
          "tune_stats_impl does not resolve 'auto' to the kernel form")
    pipe = DepthPipeline(cal, auto, min_depth=0.2, max_depth=4.0)
    with Recorder(torch, [(sgm_cuda, "wta_stats_from_duals")]) as rec:
        res = pipe(left_np, right_np)
        torch.cuda.synchronize()
    hf, hb = max(rec.calls["wta_stats_from_duals"], key=lambda c: c[0][0].shape[0])[0]
    kernel_stats = sgm_cuda.wta_stats_from_duals(hf, hb)
    _, *summed_stats = sgm_cuda.sum_wta((hf, hb), emit_sum=False)
    for a, b in zip(kernel_stats, summed_stats):
        check(a.dtype == b.dtype and torch.equal(a, b),
              f"the two statistics forms differ at {tuple(hf.shape)}")
    xla_stats = DepthPipeline(cal, dataclasses.replace(auto, stats_impl="xla"), min_depth=0.2,
                              max_depth=4.0)(left_np, right_np)
    check(torch.equal(res.disparity, xla_stats.disparity)
          and torch.equal(res.confidence, xla_stats.confidence),
          "stats_impl='xla' gives another production frame than the kernel form")
    best, times = autotune.timed_best(
        {"pallas": sgm_cuda.wta_stats_from_duals,
         "xla": lambda a, b: sgm_cuda.sum_wta((a, b), emit_sum=False)}, (hf, hb))
    print(f"autotune: 'auto' resolves to the kernel form; both statistics forms bit-identical "
          f"at {tuple(hf.shape)} {hf.dtype} and on the production frame; timed_best "
          f"{ {k: round(v * 1e3, 4) for k, v in times.items()} } ms a call, best {best}")
    print(f"frames of phase 11 (card {card}): agg_wseg=5 {seg_ms:.3f} ms, proc_scale=0.5 "
          f"{half_ms:.3f}, exact_speckle {speckle_ms:.3f} (post-pass {post_ms:.3f}, {rounds} "
          f"rounds), production {prod_ms:.3f}")
    return {"launches": n_launch, "max_abs_err": err, "ms": k_ms, "device_ms": k_dev,
            "plain_ms": k_plain, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "library_device_ms": lib_dev, "remap_separable_ms": sep_ms,
            "remap_separable_device_ms": sep_dev, "remap_ms": exact_ms,
            "remap_device_ms": exact_dev,
            "timed_as": "the 8 shift_gather launches of remap_separable on a 720p pair"}


# the fused cell (phase 12): the 1280x720 rig at the reference's
# PROCESSING_SCALE, processed at 422x236 with D=96
FUSED_SCALE = 0.33
FUSED_PROC = (422, 236)
FUSED_D = 96
FUSED_CHUNK = 8
FUSED_CHUNKS = (8, 8, 4)           # the stream's timed frames, FRAMES in all
FUSED_KERNELS = ("census_words", "cost_volume", "aggregate_dual", "sum_wta", "right_disparity",
                 "shift_gather", "speckle_counts", "wta_stats_from_duals")
COVERED = 15.0                     # a covered lens: dark and flat


def fused_frames(planes, n: int):
    """The production rig as a camera's uint8 frames, panning 1 px a frame,
    its contrast stretched 3x about mid-grey: at the processing size the
    rig's box-filtered texture has a block std of ~11, which the occlusion
    detector (blocks below 22.4 score as a covered lens) reads as both
    cameras occluded, and the hysteresis would turn stereo off after 10
    frames. The disparities are the rig's."""
    left, right = (np.clip((p - 127.5) * 3.0 + 127.5, 0, 255).astype(np.uint8) for p in planes)
    return [(np.roll(left, k, 1), np.roll(right, k, 1)) for k in range(n)]


def profiled_device_ms(torch, fn):
    """(ms of device time in one call of ``fn``: the self device time of
    every kernel and copy in a ``torch.profiler`` trace, the largest five
    by name), or (None, why) where the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    on_card = torch.autograd.DeviceType.CUDA
    rows = [(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0),
             e.key) for e in prof.key_averages() if e.device_type == on_card]
    total = sum(t for t, _ in rows) / 1e3
    if total <= 0:
        return None, "the profile holds no device time"
    top = sorted(rows, reverse=True)[:5]
    return total, [(name[:60], round(t / 1e3, 4)) for t, name in top]


class plain_kernels(eager_engine):
    """While active, every engine kernel wrapper of ``sgm_cuda`` is its plain
    version: the same frame with no kernel of the repo; the engine runs
    eagerly."""

    def __init__(self, sgm_cuda):
        self.mod = sgm_cuda
        self.saved = {}

    def __enter__(self):
        super().__enter__()
        for name in (*KERNELS, *NAMED_KERNELS):
            self.saved[name] = getattr(self.mod, name)
            setattr(self.mod, name, plain_of(self.mod, name))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.mod, name, fn)
        super().__exit__(*exc)


def sync_count(torch, fn):
    """Synchronising calls in ``fn`` (``torch.cuda.set_sync_debug_mode("warn")``),
    by the innermost line of the port (or of this script) that made them:
    (count, {line: count})."""
    import collections
    import traceback
    import warnings

    where = collections.Counter()
    inside = [False]  # set_sync_debug_mode's own first-use warning is no sync of fn's

    def hook(message, category, filename, lineno, file=None, line=None):
        if inside[0] and "synchroniz" in str(message):
            ours = [f for f in traceback.extract_stack()[:-1]
                    if "stereovision_tpu_torch" in f.filename or "chip_smoke" in f.filename]
            f = ours[-1] if ours else None
            where[f"{'/'.join(f.filename.split('/')[-2:])}:{f.lineno} via "
                  f"{filename.rsplit('/', 1)[-1]}:{lineno}" if f else
                  f"{filename}:{lineno}"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        inside[0] = True
        try:
            fn()
        finally:
            inside[0] = False
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum(where.values()), dict(where)


def fused_phase(torch, card: str, cal, planes):
    """Phase 12, the fused three-method path (``FusedPipeline``) on the
    production rig at ``scale=0.33`` (422x236, D=96; MidasSmall with the
    bundled weights at 256x256; flow depth; the 1280x720 uint8 frames pan
    1 px a frame, so the ego-motion is valid and flow joins):

    a. one steady-state frame's kernel launches, each replayed against its
       plain version (exact); the next frame counted (every kernel of the
       hierarchical engine must launch, as often as recorded);
    b. the frame against its twin with every kernel replaced by its plain
       version on the card, both pipelines fed the same frames: the stereo
       stage's ``valid`` exact and disparity within 1e-4 px, ``fused``
       within 0.1, ``mode``, ``camera_moving`` and the occlusion state
       exact;
    c. the covered left camera: 14 frames per frame and a chunk of 8 in
       ``stream`` flip the hysteresis to "left" (the mode to MiDaS or flow);
       8 uncovered frames in ``stream`` flip it back;
    d. ``FlowDepthParams(warp_impl="shift")``: its #7 launches against
       their plain version (exact), the frame timed beside the gather form;
       MidasSmall on the card against the CPU, and the fused frame, with
       TF32 on and off;
    e. ms per frame and frames/s, per frame and in ``stream`` chunks of 8
       (3 warm-up frames, 20 timed), peak memory; the device time of one
       frame and of each stage (:func:`profiled_device_ms`), and with the
       frame's time the device's idle share; each stage's recorded calls
       replayed alone; the synchronising
       calls of one steady-state frame and of one stream chunk
       (``torch.cuda.set_sync_debug_mode("warn")``).

    Returns the launches of one fused frame by kernel name."""
    from stereovision_tpu_torch import fusion, mono
    from stereovision_tpu_torch.mono import depth as mdepth
    from stereovision_tpu_torch.mono import nn as mnn
    from stereovision_tpu_torch.ops import sgm_cuda
    from stereovision_tpu_torch.pipeline import FusedPipeline
    from stereovision_tpu_torch.stereo import sgm

    frames = fused_frames(planes, 64)
    covered = np.full((H, W), int(COVERED), np.uint8)

    def make(**kw):
        p = FusedPipeline(cal, scale=FUSED_SCALE, **kw)
        check(p.proc == FUSED_PROC and p.sgm.num_disparities == FUSED_D,
              f"fused cell: processed at {p.proc}, D={p.sgm.num_disparities}")
        return p

    def run(pipe, ks, left=None):
        out = None
        for k in ks:
            out = pipe(frames[k][0] if left is None else left, frames[k][1], t_now=k / 30.0)
        return out

    t0 = time.perf_counter()
    pipe = make()
    print(f"fused: FusedPipeline built in {time.perf_counter() - t0:.2f} s (processing size "
          f"{pipe.proc}, D={pipe.sgm.num_disparities}, MidasSmall with the bundled weights)")

    # -- 12a. the frame's launches against their plain versions, counted ----
    run(pipe, range(2))
    with Recorder(torch, [(sgm_cuda, n) for n in (*KERNELS, *NAMED_KERNELS)]) as rec:
        run(pipe, [2])
        torch.cuda.synchronize()
    calls = {k: v for k, v in rec.calls.items() if v}
    err = parity(torch, sgm_cuda, calls, "the fused frame")
    sgm_cuda.reset_launch_counts()
    out = run(pipe, [3])
    torch.cuda.synchronize()
    counts = {k: n for k, n in sgm_cuda.launch_counts().items() if n}
    recorded = {NAMED_KERNELS.get(k, (k,))[0]: len(v) for k, v in calls.items()}
    print(f"launches in one fused frame: {counts}")
    for k in FUSED_KERNELS:
        check(counts.get(k, 0) > 0, f"fused: kernel {k} was not launched")
    check(counts == recorded, f"fused: counted {counts}, recorded {recorded}")
    check(int(out["mode"]) == 1 and bool(out["camera_moving"]) and out["occlusion"] == "none",
          f"fused: mode {int(out['mode'])}, moving {bool(out['camera_moving'])}, "
          f"occlusion {out['occlusion']} on the panning rig")
    del rec, calls

    # -- 12b. against the same frames with every kernel plain ---------------
    twin_k, twin_p = make(), make()
    got = run(twin_k, range(4))
    with plain_kernels(sgm_cuda):
        sgm_cuda.reset_launch_counts()
        want = run(twin_p, range(4))
        torch.cuda.synchronize()
        check(not any(sgm_cuda.launch_counts().values()), "the plain twin launched a kernel")
        from stereovision_tpu_torch.utils.backend import upload

        lr, rr = twin_p._rectify(upload(frames[3][0], twin_p.device),
                                 upload(frames[3][1], twin_p.device))
        d_plain, v_plain = sgm.compute_disparity(lr, rr, twin_p.sgm)
    d_kern, v_kern = sgm.compute_disparity(lr, rr, twin_k.sgm)
    torch.cuda.synchronize()
    check(torch.equal(v_kern, v_plain), "fused: the stereo stage's valid differs from the plain")
    d_err = (d_kern - d_plain).abs()[v_kern].max().item() if bool(v_kern.any()) else 0.0
    check(d_err <= 1e-4, f"fused: the stereo disparity differs from the plain by {d_err}")
    f_err = (got["fused"] - want["fused"]).abs().max().item()
    check(f_err <= 0.1, f"fused: fused differs from the plain twin by {f_err}")
    for key in ("mode", "camera_moving"):
        check(torch.equal(got[key], want[key]), f"fused: {key} differs from the plain twin")
    check(got["occlusion"] == want["occlusion"], "fused: the occlusion state differs")
    print(f"fused frame against its plain-kernel twin on the card: valid exact "
          f"({v_kern.float().mean().item():.4f} of pixels), disparity max abs err {d_err}, fused "
          f"max abs err {f_err}, mode {int(got['mode'])} and occlusion '{got['occlusion']}' equal")
    del twin_k, twin_p, got, want, lr, rr, d_plain, d_kern

    # -- 12c. the covered camera --------------------------------------------
    out = run(pipe, range(4, 18), left=covered)
    check(pipe.hysteresis.state == "left" and int(out["mode"]) in (2, 3),
          f"fused: 14 covered frames left the state '{pipe.hysteresis.state}', "
          f"mode {int(out['mode'])}")
    st = make()
    lefts = np.stack([covered] * FUSED_CHUNK)
    rights = np.stack([frames[k][1] for k in range(FUSED_CHUNK)])
    outs = st.stream(lefts, rights)
    codes, modes = outs["occlusion_code"].tolist(), outs["mode"].tolist()
    check(codes[-1] == 1 and st.hysteresis.state == "left" and modes[-1] in (2, 3)
          and modes[0] == 1, f"fused stream: covered chunk codes {codes}, modes {modes}")
    outs = st.stream(np.stack([frames[k][0] for k in range(FUSED_CHUNK)]), rights,
                     t0=FUSED_CHUNK / 30.0)
    back = outs["mode"].tolist()
    check(st.hysteresis.state == "none" and back[-1] == 1,
          f"fused stream: uncovered chunk left '{st.hysteresis.state}', modes {back}")
    print(f"fused covered camera: per frame '{pipe.hysteresis.state}' after 14 frames (mode "
          f"{int(out['mode'])}); stream codes {codes}, modes {modes}, then modes {back} "
          f"uncovered (state '{st.hysteresis.state}')")
    del st, outs

    # -- 12d. variants: the shift warp, TF32 ----------------------------------
    shift = make()
    shift.flow_params = mono.FlowDepthParams(warp_impl="shift")
    run(shift, range(2))
    with Recorder(torch, [(sgm_cuda, "shift_gather")]) as rec:
        run(shift, [2])
        torch.cuda.synchronize()
    n_shift = len(rec.calls["shift_gather"])
    check(n_shift > counts["shift_gather"],
          f"warp_impl='shift': {n_shift} #7 launches, not more than the gather form's")
    shift_err = parity(torch, sgm_cuda, {"shift_gather": rec.calls["shift_gather"]},
                       "the fused frame, warp_impl='shift'")
    del rec
    gather = make()
    run(gather, range(2))

    def frame_ms(p, start):
        ks = range(start, start + 5)
        return cuda_ms(torch, lambda: run(p, ks), 2, warmup=1) / len(ks)

    turns = [frame_ms(p, 2 + 10 * i) for i, p in enumerate((gather, shift, shift, gather))]
    print(f"fused warp_impl='shift': {n_shift} #7 launches a frame (the gather form "
          f"{counts['shift_gather']}), exact against their plain version; in turns (gather, "
          f"shift, shift, gather) {[round(t, 3) for t in turns]} ms/frame, card {card}")
    del shift, gather

    model_cpu = mnn.create_model(device="cpu")
    x = torch.from_numpy(np.random.default_rng(SEED).uniform(0, 1, (1, 256, 256, 3))
                         .astype(np.float32))
    with torch.no_grad():
        ref = model_cpu(x)
    span = (ref.max() - ref.min()).item()
    tf32_was = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    tf32 = {}
    # (cuDNN's flag, the matmul flag): off, PyTorch's defaults, both on
    for flags in ((False, False), (True, False), (True, True)):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
        with torch.no_grad():
            got = pipe.model(x.cuda()).cpu()
        t_twin = make()
        tf32[flags] = ((got - ref).abs().max().item() / span, run(t_twin, range(3))["fused"])
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32_was
    off = tf32[(False, False)]
    moved = {f: (tf32[f][1] - off[1]).abs() for f in tf32}
    check(off[0] <= 1e-4, f"MidasSmall on the card differs from the CPU by {off[0]} of its "
                          f"range with TF32 off")
    print("MidasSmall on the card against the CPU at 256x256 (max abs err over the output's "
          f"range, {span:.2f}), and the fused frame against TF32 off (max abs err; pixels above "
          "0.1): " + "; ".join(
              f"cudnn.allow_tf32={c} matmul.allow_tf32={m}: {tf32[(c, m)][0]:.3e}, fused "
              f"{moved[(c, m)].max().item():.4f}, {int((moved[(c, m)] > 0.1).sum())} px"
              for c, m in tf32))
    del model_cpu, tf32, moved

    # -- 12e. times ------------------------------------------------------------
    base = 2 * WARMUP
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    timed = make()
    run(timed, range(base, base + WARMUP))
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run(timed, range(base + WARMUP, base + WARMUP + FRAMES))
    end.record()
    end.synchronize()
    frame_ms_ = start.elapsed_time(end) / FRAMES
    peak = torch.cuda.max_memory_allocated() - held
    print(f"frame fused per frame: {frame_ms_:.3f} ms/frame, {1e3 / frame_ms_:.2f} frames/s "
          f"(1280x720 uint8 pair -> {FUSED_PROC[0]}x{FUSED_PROC[1]}, D={FUSED_D}, MidasSmall "
          f"256x256, flow; {FRAMES} timed frames after {WARMUP} warm-up; host-to-device copy "
          f"included), peak device memory {peak / 1e9:.3f} GB above the {held / 1e9:.2f} GB this "
          f"script holds, card {card}")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    st = make()
    k0 = base + WARMUP + FRAMES
    chunks, k = [], k0 + WARMUP
    for n in FUSED_CHUNKS:
        chunks.append((np.stack([frames[j][0] for j in range(k, k + n)]),
                       np.stack([frames[j][1] for j in range(k, k + n)]), k / 30.0))
        k += n
    st.stream(np.stack([frames[j][0] for j in range(k0, k0 + WARMUP)]),
              np.stack([frames[j][1] for j in range(k0, k0 + WARMUP)]), t0=k0 / 30.0)
    torch.cuda.synchronize()
    start.record()
    for lefts, rights, t in chunks:
        outs = st.stream(lefts, rights, t0=t)
    end.record()
    end.synchronize()
    stream_ms = start.elapsed_time(end) / FRAMES
    stream_peak = torch.cuda.max_memory_allocated() - held
    check(timed.hysteresis.state == "none" and st.hysteresis.state == "none",
          f"fused: the timed pipelines left stereo ('{timed.hysteresis.state}', "
          f"'{st.hysteresis.state}')")
    check(outs["fused"].shape == (FUSED_CHUNKS[-1], FUSED_PROC[1], FUSED_PROC[0])
          and bool(torch.isfinite(outs["fused"]).all()) and bool(torch.isfinite(outs["meters"]).all()),
          "fused stream: outputs of the wrong shape or not finite")
    print(f"frame fused stream: {stream_ms:.3f} ms/frame, {1e3 / stream_ms:.2f} frames/s (chunks "
          f"{list(FUSED_CHUNKS)} of uint8 frames after a warm-up chunk of {WARMUP}), peak device "
          f"memory {stream_peak / 1e9:.3f} GB above the {held / 1e9:.2f} GB this script holds, "
          f"card {card}")

    # the synchronising calls of one steady-state frame and of one chunk

    k = base + WARMUP + FRAMES
    n_frame, where_frame = sync_count(torch, lambda: run(timed, [k]))
    lefts, rights, t = chunks[0]
    n_chunk, where_chunk = sync_count(torch, lambda: st.stream(lefts, rights, t0=t))
    print(f"fused synchronising calls (set_sync_debug_mode('warn')): {n_frame} in one "
          f"steady-state frame {where_frame}, besides the wait for the previous frame's "
          f"occlusion scores (an event); {n_chunk} in one stream chunk of {FUSED_CHUNK} "
          f"{where_chunk}")

    # the frame's device time: the kernels' time in a profile of one
    # steady-state frame (the frame's eigh syncs, so it cannot be captured
    # in a graph)
    dev_frame, top = profiled_device_ms(torch, lambda: run(timed, [k + 1]))
    idle = "not measured" if dev_frame is None else f"{1 - dev_frame / frame_ms_:.3f}"
    print(f"fused frame on the device: {fmt(dev_frame)} of kernels and copies in one "
          f"steady-state frame (torch.profiler), per frame {frame_ms_:.3f} ms: the device's "
          f"idle share {idle}; the largest: {top}; card {card}")

    # stages: one steady-state frame's calls of each, replayed alone
    stage_targets = [(FusedPipeline, "_rectify"), (fusion, "occlusion_scores"),
                     (FusedPipeline, "_stereo"), (mnn, "estimate_depth"),
                     (mono, "flow_depth_step"), (mdepth, "dense_flow"),
                     (mdepth, "estimate_ego_motion"), (torch.linalg, "eigh"),
                     (fusion, "calibrate_midas_to_stereo"),
                     (fusion, "normalize_to_stereo_range"), (fusion, "fuse_depth_maps"),
                     (FusedPipeline, "_meters")]
    with Recorder(torch, stage_targets) as rec:
        run(timed, [k + 2])
        torch.cuda.synchronize()
    stage_ms = {}
    for mod, name in stage_targets:
        stage_calls = rec.calls[name]
        fn = getattr(mod, name)
        ms = cuda_ms(torch, lambda: [fn(*a, **kw) for a, kw in stage_calls], 5)
        dev, _ = profiled_device_ms(torch, lambda: [fn(*a, **kw) for a, kw in stage_calls])
        stage_ms[name] = ms
        print(f"stage fused {name} ({len(stage_calls)} call(s) of one frame): {ms:.3f} ms, "
              f"device alone {fmt(dev)} ({100 * ms / frame_ms_:.1f}% of the frame)")
    fusion_ms = sum(stage_ms[n] for n in ("calibrate_midas_to_stereo", "normalize_to_stereo_range",
                                          "fuse_depth_maps", "_meters"))
    print(f"fused stages (card {card}): rectification {stage_ms['_rectify']:.3f} ms, occlusion "
          f"{stage_ms['occlusion_scores']:.3f}, stereo {stage_ms['_stereo']:.3f}, MidasSmall "
          f"{stage_ms['estimate_depth']:.3f}, flow depth {stage_ms['flow_depth_step']:.3f} "
          f"(eigh {stage_ms['eigh']:.3f}), calibration and fusion {fusion_ms:.3f}; the frame "
          f"{frame_ms_:.3f} ms per frame, {stream_ms:.3f} streamed, against the 33.3 ms of a "
          f"30 frames/s camera")
    del rec
    return {"launches": counts, "max_abs_err": max(err, shift_err), "ms": frame_ms_,
            "stream_ms": stream_ms}


# the mono-depth networks (phase 13): each exact architecture at the sizes
# the path gives it (MidasV21Small at 256x256; DPT-Large at its native
# 384x384 and at 256x256, mono_ai's and FusedPipeline's net_hw)
MONO_SIZES = {"midas_v21_small": ((256, 256),), "dpt_large": ((384, 384), (256, 256))}
MONO_TOL = 1e-4                    # of the output's range, against the CPU, TF32 off
TF32_PEAK_OPS_PER_S = 495e12       # H100 SXM dense TF32 (NVIDIA data sheet)


def head_conv_probe(torch, card: str, conv, hw):
    """DPT-Large's head convolution (3x3, 256 → 128, at half the input's
    size) alone on a seeded input, TF32 off: through cuDNN, with cuDNN
    disabled (PyTorch's own im2col and GEMM), and through cuDNN with TF32 on;
    ms (events, 5 calls) and peak memory above its input, each within
    ``MONO_TOL`` of a float64 product on the card."""
    dev = conv.weight.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(1, conv.in_channels, hw[0] // 2, hw[1] // 2, device=dev, generator=gen)
    with torch.no_grad():
        ref = torch.nn.functional.conv2d(x.double(), conv.weight.double(), conv.bias.double(),
                                         padding=1)
        span = (ref.max() - ref.min()).item()
        rows = []
        for label, cudnn_on, tf32 in (("cuDNN", True, False), ("no cuDNN", False, False),
                                      ("cuDNN, TF32", True, True)):
            torch.backends.cudnn.allow_tf32 = tf32
            with torch.backends.cudnn.flags(enabled=cudnn_on, allow_tf32=tf32):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                err = (conv(x).double() - ref).abs().max().item() / span
                peak = torch.cuda.max_memory_allocated() - held
                ms = cuda_ms(torch, lambda: conv(x), 5)
            if not tf32:
                check(err <= MONO_TOL, f"the head conv ({label}) differs from float64 by {err}")
            rows.append(f"{label} {ms:.3f} ms, {peak / 1e9:.3f} GB, {err:.1e} of the range")
        torch.backends.cudnn.allow_tf32 = False
    print(f"mono dpt_large head conv alone at {hw[0] // 2}x{hw[1] // 2} ({conv.in_channels} -> "
          f"{conv.out_channels}, 3x3): " + "; ".join(rows) + f"; card {card}")


def mono_models_phase(torch, card: str, cal, planes):
    """Phase 13, the exact MiDaS architectures with seeded weights
    (``mono.nn.create_model(arch, seed=SEED)``, built on the CPU):

    a. each network's hub checkpoint: ``torch.save`` of its seeded
       ``state_dict``, then ``create_model(arch, torch_state_dict=path)`` on
       the card, whose output must equal the seeded module moved to the card
       (exact);
    b. each network on the card at each size of ``MONO_SIZES`` against the
       same module's forward on the CPU, with TF32 off: within ``MONO_TOL``
       of the CPU output's range (its range must not be 0); with TF32 on,
       the difference printed; each forward's operations counted on the CPU
       (``torch.utils.flop_counter``) and its bound at the float32 and TF32
       peaks; DPT-Large's head convolution alone (:func:`head_conv_probe`);
    c. each forward timed with TF32 off and on: events around 20 calls
       (host included) and the device time of one call (``torch.profiler``),
       and its peak memory above what the script holds (the weights among
       it);
    d. ``FusedPipeline(calibration(), scale=0.33, midas_arch=arch,
       midas_checkpoint=path)`` on phase 12's rig: the frame against its
       twin with every kernel plain (fused within 0.1, mode, camera_moving
       and occlusion equal), one frame's launches replayed against their
       plain versions (exact), the next counted (the kernels of the hier
       engine must launch, as often as recorded), ms per frame (3 warm-up,
       20 timed) and the device's idle share;
    e. ``apps.mono_ai``'s work on a 1280x720 frame for each of its three
       archs (``frame_view``, then the copy to the host the PNG needs),
       timed. Where ``matplotlib`` is missing its TURBO table is a seeded
       stand-in: the same 256-entry gather.

    Returns the launches of one fused frame by arch and kernel name."""
    import copy
    import importlib.util
    import tempfile

    from torch.utils.flop_counter import FlopCounterMode

    from stereovision_tpu_torch.apps import mono_ai
    from stereovision_tpu_torch.core import image as im
    from stereovision_tpu_torch.mono import nn as mnn
    from stereovision_tpu_torch.ops import sgm_cuda
    from stereovision_tpu_torch.pipeline import FusedPipeline

    def tf32(on: bool):
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on

    frames = fused_frames(planes, 2 * WARMUP + FRAMES + 8)
    launches = {}
    workdir = tempfile.TemporaryDirectory(prefix="chip_smoke_mono_")
    models = {"small": mnn.create_model(device="cuda")}
    try:
        for arch, sizes in MONO_SIZES.items():
            # -- 13a. the hub checkpoint -----------------------------------------
            t0 = time.perf_counter()
            cpu = mnn.create_model(arch, seed=SEED, device="cpu")
            built_s = time.perf_counter() - t0
            path = f"{workdir.name}/{arch}.pt"
            torch.save(cpu.state_dict(), path)
            t0 = time.perf_counter()
            model = mnn.create_model(arch, torch_state_dict=path, device="cuda")
            loaded_s = time.perf_counter() - t0
            seeded = copy.deepcopy(cpu).cuda()
            x = torch.from_numpy(np.random.default_rng(SEED).uniform(0, 1, (1, *sizes[0], 3))
                                 .astype(np.float32))
            with torch.no_grad():
                same = torch.equal(model(x.cuda()), seeded(x.cuda()))
            check(same, f"{arch}: the checkpoint-loaded network differs from the seeded one")
            n_params = sum(p.numel() for p in cpu.parameters())
            print(f"mono {arch}: {n_params:,} parameters, seeded on the CPU in {built_s:.2f} s; "
                  f"its state_dict through torch.save and create_model(torch_state_dict=path) "
                  f"onto the card in {loaded_s:.2f} s, output equal to the seeded module's")
            del seeded
            torch.cuda.empty_cache()
            models[arch] = model

            for hw in sizes:
                # -- 13b. against the CPU -------------------------------------
                x = torch.from_numpy(np.random.default_rng(SEED + hw[0])
                                     .uniform(0, 1, (1, *hw, 3)).astype(np.float32))
                with torch.no_grad(), FlopCounterMode(display=False) as flops:
                    ref = cpu(x)
                n_ops = flops.get_total_flops()
                span = (ref.max() - ref.min()).item()
                check(span > 0 and bool(torch.isfinite(ref).all()),
                      f"{arch} {hw}: the CPU output's range is {span}")
                xc = x.cuda()
                errs, times = {}, {}
                for on in (False, True):
                    tf32(on)
                    with torch.no_grad():
                        got = model(xc)
                        errs[on] = (got.cpu() - ref).abs().max().item() / span
                        check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
                              f"{arch} {hw}: output {tuple(got.shape)} or not finite")
                        # -- 13c. times and memory ----------------------------
                        fn = lambda: model(xc)  # noqa: E731
                        ms = cuda_ms(torch, fn, FRAMES, warmup=3)
                        dev, top = profiled_device_ms(torch, fn)
                        torch.cuda.synchronize()
                        torch.cuda.reset_peak_memory_stats()
                        held = torch.cuda.memory_allocated()
                        fn()
                        torch.cuda.synchronize()
                        peak = torch.cuda.max_memory_allocated() - held
                    times[on] = (ms, dev, peak, held, top)
                tf32(False)
                check(errs[False] <= MONO_TOL,
                      f"{arch} {hw} on the card differs from the CPU by {errs[False]:.3e} of its "
                      f"range with TF32 off")
                b32, btf = n_ops / OPS_PER_S * 1e3, n_ops / TF32_PEAK_OPS_PER_S * 1e3
                print(f"mono {arch} at {hw[0]}x{hw[1]}: against the CPU {errs[False]:.3e} of the "
                      f"output's range ({span:.4g}) with TF32 off, {errs[True]:.3e} on; "
                      f"{n_ops / 1e9:.2f} G operations (bound {b32:.4f} ms at the float32 peak, "
                      f"{btf:.4f} at TF32's)")
                for on in (False, True):
                    ms, dev, peak, held, top = times[on]
                    print(f"mono {arch} at {hw[0]}x{hw[1]}, TF32 {'on' if on else 'off'}: "
                          f"{ms:.3f} ms a forward (events, {FRAMES} calls), device "
                          f"{fmt(dev)}, peak memory {peak / 1e9:.3f} GB above the {held / 1e9:.2f} "
                          f"GB held, largest: {top}; card {card}")
            if arch == "dpt_large":
                head_conv_probe(torch, card, model.scratch.output_conv[0], sizes[0])
            del cpu, ref
            torch.cuda.empty_cache()

            # -- 13d. the fused frame with this network ------------------------
            def make():
                p = FusedPipeline(cal, scale=FUSED_SCALE, midas_arch=arch, midas_checkpoint=path)
                check(p.proc == FUSED_PROC and p.sgm.num_disparities == FUSED_D,
                      f"fused {arch}: processed at {p.proc}, D={p.sgm.num_disparities}")
                return p

            def run(pipe, ks):
                out = None
                for k in ks:
                    out = pipe(frames[k][0], frames[k][1], t_now=k / 30.0)
                return out

            pipe, twin = make(), make()
            got = run(pipe, range(4))
            with plain_kernels(sgm_cuda):
                sgm_cuda.reset_launch_counts()
                want = run(twin, range(4))
                torch.cuda.synchronize()
                check(not any(sgm_cuda.launch_counts().values()),
                      f"fused {arch}: the plain twin launched a kernel")
            f_err = (got["fused"] - want["fused"]).abs().max().item()
            check(f_err <= 0.1, f"fused {arch}: fused differs from the plain twin by {f_err}")
            for key in ("mode", "camera_moving"):
                check(torch.equal(got[key], want[key]),
                      f"fused {arch}: {key} differs from the plain twin")
            check(got["occlusion"] == want["occlusion"] == "none",
                  f"fused {arch}: occlusion '{got['occlusion']}' / '{want['occlusion']}'")
            del twin, want
            torch.cuda.empty_cache()
            with Recorder(torch, [(sgm_cuda, n) for n in (*KERNELS, *NAMED_KERNELS)]) as rec:
                run(pipe, [4])
                torch.cuda.synchronize()
            calls = {k: v for k, v in rec.calls.items() if v}
            err = parity(torch, sgm_cuda, calls, f"the fused frame with {arch}")
            del rec
            sgm_cuda.reset_launch_counts()
            out = run(pipe, [5])
            torch.cuda.synchronize()
            counts = {k: n for k, n in sgm_cuda.launch_counts().items() if n}
            recorded = {NAMED_KERNELS.get(k, (k,))[0]: len(v) for k, v in calls.items()}
            del calls
            print(f"launches in one fused frame with {arch}: {counts}")
            for k in FUSED_KERNELS:
                check(counts.get(k, 0) > 0, f"fused {arch}: kernel {k} was not launched")
            check(counts == recorded, f"fused {arch}: counted {counts}, recorded {recorded}")
            check(int(out["mode"]) == 1 and bool(torch.isfinite(out["fused"]).all()),
                  f"fused {arch}: mode {int(out['mode'])} on the panning rig")
            launches[arch] = counts
            base = 6
            run(pipe, range(base, base + WARMUP))
            ms = cuda_ms(torch, lambda: run(pipe, range(base + WARMUP, base + WARMUP + FRAMES)),
                         1, warmup=0) / FRAMES
            dev, top = profiled_device_ms(torch, lambda: run(pipe, [base + WARMUP + FRAMES]))
            idle = "not measured" if dev is None else f"{1 - dev / ms:.3f}"
            print(f"frame fused with {arch}: {ms:.3f} ms/frame, {1e3 / ms:.2f} frames/s "
                  f"({FRAMES} timed frames after {WARMUP} warm-up; the twin with every kernel "
                  f"plain: fused max abs err {f_err}; launches exact, max abs err {err}); "
                  f"device {fmt(dev)} a frame, idle share {idle}; largest: {top}; card {card}")
            del pipe, out
            torch.cuda.empty_cache()

        # -- 13e. mono_ai's work on a 720p frame --------------------------------
        if importlib.util.find_spec("matplotlib") is None:
            stand_in = np.random.default_rng(SEED).uniform(0, 255, (256, 3)).astype(np.float32)
            im._turbo_lut = lambda: stand_in
            print("mono_ai: matplotlib is not installed here; the TURBO table is a seeded "
                  "stand-in (the same gather)")
        frame = np.ascontiguousarray(np.stack([planes[0]] * 3, axis=-1))
        for arch, model in models.items():
            def view():
                return mono_ai.frame_view(model, frame, "cuda").to(torch.uint8).cpu()

            vis = view()
            check(vis.shape == (H, W, 3) and vis.dtype == torch.uint8,
                  f"mono_ai {arch}: a view of {tuple(vis.shape)} {vis.dtype}")
            ms = cuda_ms(torch, view, 10, warmup=2)
            print(f"mono_ai {arch}: {ms:.3f} ms a {W}x{H} frame (estimate_depth at 256x256, the "
                  f"inverted TURBO view, the copy to the host); card {card}")
    finally:
        tf32(False)
        workdir.cleanup()
    return launches


# -- phase 14: calibration and SfM -----------------------------------------

BOARD, SQUARE_CM = (9, 6), 2.5
CAL_PAIRS = 12
CAL_F = 1000.0                     # both cameras' focal length (px); UNIVERSAL ties them
CAL_K = ((CAL_F, 645.5, 357.5), (CAL_F, 634.0, 362.5))    # (f, cx, cy) left, right
CAL_DIST = ((-0.08, 0.02, 0.0, 0.0, 0.0), (-0.06, 0.015, 0.0, 0.0, 0.0))   # barrel
CAL_ROT = (0.004, -0.01, 0.002)    # rad, the right camera's rotation
CAL_T = (-6.0, 0.05, 0.1)          # cm, baseline ~6 cm
CAL_NOISE = 1.0                    # grey levels
PLANE_CM = 150.0                   # the calibrated pipeline's textured plane
SFM_FRAMES, SFM_CORNERS = 64, 512
SFM_Z = (400.0, 150.0)             # cm: the far plane, the near one
SFM_STEP_CM = 4.0                  # the camera's x translation a frame
NEAR_BAND = (260, 260)             # the near plane's first row and height
BA_ITERS, BA_CHUNK = 10, 5
# card against the CPU: corners (px), calibration results (relative),
# camera poses and landmarks (relative)
CORNER_TOL, CALIB_TOL, SFM_TOL = 1e-3, 1e-6, 1e-6


def _k(i):
    f, cx, cy = CAL_K[i]
    return np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]])


def _rodrigues_np(r):
    r = np.asarray(r, np.float64)
    th = np.linalg.norm(r)
    if th < 1e-12:
        return np.eye(3)
    k = r / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def _distort_np(xy, d):
    k1, k2, p1, p2, k3 = d
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    rad = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3
    return np.stack([x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x),
                     y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y], -1)


def _rays(i):
    """Every pixel's undistorted normalized ray (x, y) of camera i, (H, W, 2):
    the distortion inverted by fixed-point steps."""
    K = _k(i)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    xd = np.stack([(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1]], -1)
    xy = xd.copy()
    for _ in range(20):
        xy = xy - (_distort_np(xy, CAL_DIST[i]) - xd)
    return xy


def _project_np(X, R, t, i):
    cam = X @ R.T + t
    xy = _distort_np(cam[:, :2] / cam[:, 2:], CAL_DIST[i])
    K = _k(i)
    return xy * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]


def _bilinear_np(tex, u, v):
    """tex sampled at float texel coordinates (u along x, v along y)."""
    u = np.clip(u, 0, tex.shape[1] - 1.001)
    v = np.clip(v, 0, tex.shape[0] - 1.001)
    x0, y0 = u.astype(np.int64), v.astype(np.int64)
    fx, fy = u - x0, v - y0
    return ((tex[y0, x0] * (1 - fx) + tex[y0, x0 + 1] * fx) * (1 - fy)
            + (tex[y0 + 1, x0] * (1 - fx) + tex[y0 + 1, x0 + 1] * fx) * fy)


def board_views(rng):
    """CAL_PAIRS stereo pairs of a 9x6 board (10x7 squares of 2.5 cm on a
    grey ground) seen by the distorted rig at 40-70 cm, rendered per pixel
    (each pixel's ray meets the board plane; the squares' edges are
    ramps a pixel wide, so each inner corner is a saddle), with noise of
    CAL_NOISE grey levels, as uint8. Returns (lefts, rights, the inner
    corners' true projections (V, 54, 2) left and right)."""
    rays = [_rays(0), _rays(1)]
    R_st, T_st = _rodrigues_np(CAL_ROT), np.asarray(CAL_T)
    w, h = BOARD
    obj = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1).reshape(-1, 2) * SQUARE_CM
    obj3 = np.concatenate([obj, np.zeros((len(obj), 1))], 1)
    ramp = 0.04  # cm, about a pixel at 50 cm

    def shade(u, v):
        def wave(s):  # distance to the nearest line, signed by the square's parity
            q = s / SQUARE_CM
            return np.where(np.floor(q) % 2 == 0, 1.0, -1.0) * np.minimum(q % 1, 1 - q % 1) \
                * SQUARE_CM
        val = 0.5 + 0.5 * np.clip(wave(u) / ramp, -1, 1) * np.clip(wave(v) / ramp, -1, 1)
        on = (u > -SQUARE_CM) & (u < w * SQUARE_CM) & (v > -SQUARE_CM) & (v < h * SQUARE_CM)
        return np.where(on, 20 + 210 * val, 110.0)

    def render(R, t, i):
        Hb = np.stack([R[:, 0], R[:, 1], t], 1)      # board (u, v, 1) → camera ray
        r = rays[i]
        q = np.stack([r[..., 0], r[..., 1], np.ones((H, W))], -1) @ np.linalg.inv(Hb).T
        img = shade(q[..., 0] / q[..., 2], q[..., 1] / q[..., 2])
        img = img + rng.normal(0, CAL_NOISE, img.shape)
        return np.clip(np.round(img), 0, 255).astype(np.uint8)

    lefts, rights, truth_l, truth_r = [], [], [], []
    centre = np.array([(w - 1) * SQUARE_CM / 2, (h - 1) * SQUARE_CM / 2, 0.0])
    while len(lefts) < CAL_PAIRS:
        R = _rodrigues_np(rng.uniform(-0.35, 0.35, 3))
        t = np.array([rng.uniform(-8, 8), rng.uniform(-5, 5), rng.uniform(40, 70)]) - R @ centre
        Rr, tr = R_st @ R, R_st @ t + T_st
        pl, pr = _project_np(obj3, R, t, 0), _project_np(obj3, Rr, tr, 1)
        if min(pl.min(), pr.min()) < 40 or max(pl[:, 0].max(), pr[:, 0].max()) > W - 40 \
                or max(pl[:, 1].max(), pr[:, 1].max()) > H - 40:
            continue
        lefts.append(render(R, t, 0))
        rights.append(render(Rr, tr, 1))
        truth_l.append(pl)
        truth_r.append(pr)
    return lefts, rights, np.asarray(truth_l), np.asarray(truth_r)


def plane_pair(rng):
    """The distorted rig facing a textured plane PLANE_CM in front of the
    left camera (fronto-parallel to it), 0.15 cm a texel: each pixel's ray
    meets the plane."""
    R_st, T_st = _rodrigues_np(CAL_ROT), np.asarray(CAL_T)
    texel = 0.15
    tex = texture(rng, 1100, 1700)
    out = []
    for i in (0, 1):
        r = _rays(i)
        ray = np.stack([r[..., 0], r[..., 1], np.ones((H, W))], -1)
        if i == 0:
            X = ray * PLANE_CM
        else:  # X_l = Rᵀ(s·ray − T) with z_l = PLANE_CM
            d = ray @ R_st            # Rᵀ·ray, row-wise
            RtT = R_st.T @ T_st
            s = (PLANE_CM + RtT[2]) / d[..., 2]
            X = s[..., None] * d - RtT
        img = _bilinear_np(tex, X[..., 0] / texel + 850, X[..., 1] / texel + 550)
        out.append(img.astype(np.float32))
    return out


def sfm_frames(rng):
    """SFM_FRAMES 1280x720 frames of a camera translating SFM_STEP_CM a frame
    along x, with a wobble along y, before two fronto-parallel textured
    planes: a far one filling the view and a near band across it (rows
    NEAR_BAND), each shifted by its own parallax (f·shift/Z, bilinear), with
    noise of 1 grey level. Returns (frames, the camera centres (F, 3) in
    cm)."""
    f = CAL_F
    y0, bh = NEAR_BAND
    travel = f * SFM_STEP_CM * SFM_FRAMES
    far = texture(rng, H + 80, W + int(travel / SFM_Z[0]) + 80)
    near = texture(rng, bh + 80, W + int(travel / SFM_Z[1]) + 80)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    band = (ys >= y0) & (ys < y0 + bh)
    frames, centres = [], []
    for k in range(SFM_FRAMES):
        c = np.array([SFM_STEP_CM * k, 0.3 * np.sin(k / 6.0), 0.0])
        # a plane at depth Z moves against the camera by f·c/Z pixels
        img = _bilinear_np(far, xs + f * c[0] / SFM_Z[0] + 40, ys + f * c[1] / SFM_Z[0] + 40)
        img = np.where(band, _bilinear_np(near, xs + f * c[0] / SFM_Z[1] + 40,
                                          ys - y0 + f * c[1] / SFM_Z[1] + 40), img)
        frames.append((img + rng.normal(0, 1.0, img.shape)).astype(np.float32))
        centres.append(c)
    return frames, np.asarray(centres)


def calib_sfm_phase(torch, card: str):
    """Phase 14, calibration and SfM on the card, on inputs rendered here
    with numpy from SEED (the card's host may lack cv2 and imageio):

    a. twelve 1280x720 stereo pairs of a 9x6 board (:func:`board_views`):
       ``detect_chessboard`` on all 24 images, against the true corners and
       against the same calls on the CPU (within CORNER_TOL px), timed;
       ``calibrate_camera`` for both cameras, ``stereo_calibrate`` with
       ``fix_intrinsic`` (from the two mono results) and with ``UNIVERSAL``,
       each against the truth (K within 0.5%, RMS under 0.3 px, |T| within
       1%) and against the CPU on the card's corners (within CALIB_TOL
       relative), with ms per LM iteration and the iteration count;
       ``stereo_rectify`` (the calibrate app's ``rectify_calibration``) and
       ``rectification_epipolar_error`` (mean |Δy| under 0.3 px);
    b. ``DepthPipeline(production_preset())`` built from the universal
       calibration on a pair of the rig facing a textured plane at
       PLANE_CM: median depth within 2%; the frame's kernel launches
       replayed against their plain versions (exact), the next frame
       counted (every kernel of the production path must launch);
    c. a 64-frame sequence (:func:`sfm_frames`): ``apps.sfm.build_tracks``
       (512 corners), ``chain_poses`` with draws from one CPU
       ``torch.Generator`` (seed 1), ``distributed_slam_ba`` (10 iterations)
       on a mesh of ``["cuda:0"]`` and of ``["cuda:0"] * 4`` (equal within
       SFM_TOL), the BA's RMS below its start and the trajectory mainly
       along x; the same sequence on the CPU (kp, matches and poses, then
       the BA); ``distributed_mono_ba`` on a's left views (four positions)
       against ``calibrate_camera``;
    d. prints detection ms (card, CPU), ms per LM iteration, build_tracks
       ms, ms per BA iteration on 1 and 4 positions, host syncs per RANSAC
       pair and per BA chunk, and the phase's peak device memory, beside
       the card.

    Returns the launches of the calibrated production frame by kernel name,
    and the landmark BA's problem (numpy) with its 1-position result."""
    from stereovision_tpu_torch.apps import calibrate as cal_app
    from stereovision_tpu_torch.apps import sfm
    from stereovision_tpu_torch.calib import (
        CalibrationFlags, calibrate_camera, detect_chessboard, stereo_calibrate,
    )
    from stereovision_tpu_torch.calib.verify import rectification_epipolar_error
    from stereovision_tpu_torch.ops import sgm_cuda
    from stereovision_tpu_torch.parallel import make_mesh
    from stereovision_tpu_torch.parallel.ba import distributed_mono_ba, mono_ba_init
    from stereovision_tpu_torch.parallel.ba_landmarks import distributed_slam_ba
    from stereovision_tpu_torch.pipeline import DepthPipeline
    from stereovision_tpu_torch.stereo import production_preset

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    rng = np.random.default_rng(SEED + 14)
    lefts, rights, truth_l, truth_r = board_views(rng)

    def timed(fn):
        return host_timed(torch, fn)

    # -- a. detection --------------------------------------------------------
    detect_chessboard(lefts[0], BOARD)  # the first call pays for the allocator
    found, det_ms = {}, {}
    for dev in ("cuda", "cpu"):
        res, ms = timed(lambda: [detect_chessboard(img, BOARD, device=dev)
                                 for img in lefts + rights])
        check(all(f for f, _ in res), f"detect_chessboard ({dev}) missed a board")
        found[dev] = np.asarray([c for _, c in res])
        det_ms[dev] = ms / len(res)
    corners_l, corners_r = found["cuda"][:CAL_PAIRS], found["cuda"][CAL_PAIRS:]
    truth = np.concatenate([truth_l, truth_r])
    # the detector may order a board from either end (a 180° turn of the grid)
    err_truth = max(min(np.abs(c - t).max(), np.abs(c[::-1] - t).max())
                    for c, t in zip(found["cuda"], truth))
    check(err_truth < 0.3, f"detected corners {err_truth} px from the truth")
    err_cpu = np.abs(found["cuda"] - found["cpu"]).max()
    check(err_cpu <= CORNER_TOL, f"corners on the card {err_cpu} px from the CPU's")
    print(f"phase 14 detect_chessboard at {W}x{H}: {det_ms['cuda']:.2f} ms an image on the card, "
          f"{det_ms['cpu']:.2f} ms on the CPU ({2 * CAL_PAIRS} images); corners within "
          f"{err_truth:.4f} px of the truth, card against CPU {err_cpu:.2e} px; card {card}")

    # -- a. calibration ------------------------------------------------------
    obj = cal_app.board_object_points(BOARD, SQUARE_CM)
    size = (W, H)
    runs = {
        "mono_left": lambda dev, tr: calibrate_camera(obj, corners_l, size, device=dev, trace=tr),
        "mono_right": lambda dev, tr: calibrate_camera(obj, corners_r, size, device=dev, trace=tr),
    }
    calibrate_camera(obj, corners_l[:3], size)  # the first call pays for the solver libraries
    results = {}
    for name, run in runs.items():
        results[name] = calib_run(torch, name, run, card)
    ml, mr = results["mono_left"], results["mono_right"]
    for name, flags, kw in (
            ("stereo_fix_intrinsic", CalibrationFlags(fix_intrinsic=True),
             dict(K1=ml["camera_matrix"], d1=ml["distortion_coefficients"],
                  K2=mr["camera_matrix"], d2=mr["distortion_coefficients"])),
            ("stereo_universal", CalibrationFlags.UNIVERSAL, {})):
        results[name] = calib_run(
            torch, name,
            lambda dev, tr, flags=flags, kw=kw: stereo_calibrate(
                obj, corners_l, corners_r, size, flags=flags, device=dev, trace=tr, **kw),
            card)
    for name, out in results.items():
        if name.startswith("mono"):
            Ks = [(out["camera_matrix"], _k(0 if name.endswith("left") else 1))]
            rms = out["reprojection_error"]
        else:
            Ks = [(out["mtx_left"], _k(0)), (out["mtx_right"], _k(1))]
            rms = out["ret"]
            t_err = abs(np.linalg.norm(out["T"]) / np.linalg.norm(CAL_T) - 1)
            check(t_err < 0.01, f"{name}: |T| off by {t_err:.4f}")
        k_err = max(float(np.max(np.abs(Ke - Kt)[Kt != 0] / Kt[Kt != 0])) for Ke, Kt in Ks)
        check(k_err < 0.005, f"{name}: K off the truth by {k_err:.4f}")
        check(rms < 0.3, f"{name}: RMS {rms} px")
        print(f"phase 14 {name}: RMS {rms:.4f} px, K within {k_err:.5f} of the truth")

    full = cal_app.rectify_calibration(results["stereo_universal"], size, BOARD, SQUARE_CM)
    epi, epi_ms = timed(lambda: rectification_epipolar_error(full, zip(lefts, rights), BOARD))
    check(epi["n_pairs"] == CAL_PAIRS and epi["mean_abs_dy"] < 0.3,
          f"rectification check {epi}")
    print(f"phase 14 rectification (universal): mean |dy| {epi['mean_abs_dy']:.4f} px (max "
          f"{epi['max_abs_dy']:.4f}) over {epi['n_pairs']} pairs, {epi_ms:.1f} ms")

    # -- b. the calibrated DepthPipeline -------------------------------------
    left_p, right_p = plane_pair(rng)
    pipe = DepthPipeline(full, production_preset(), min_depth=0.2, max_depth=4.0)
    with Recorder(torch, [(sgm_cuda, name) for name in (*KERNELS, "median_blur")]) as rec:
        pipe(left_p, right_p)
        torch.cuda.synchronize()
    parity(torch, sgm_cuda, rec.calls, "the calibrated production frame")
    sgm_cuda.reset_launch_counts()
    res = pipe(left_p, right_p)
    torch.cuda.synchronize()
    launches = {k: sgm_cuda.launch_counts()[k] for k in (*KERNELS, "median")}
    for k in launches:
        check(launches[k] > 0, f"kernel {k} was not launched on the calibrated frame")
    core = (slice(H // 4, 3 * H // 4), slice(W // 4, 3 * W // 4))
    z = res.depth_m[core][res.confidence[core] > 0]
    check(z.numel() > 0.5 * res.depth_m[core].numel(), "too few confident plane pixels")
    z_med = z.median().item()
    check(abs(z_med - PLANE_CM / 100) < 0.02 * PLANE_CM / 100,
          f"calibrated frame: median depth {z_med} m, the plane is at {PLANE_CM / 100} m")
    print(f"phase 14 calibrated production frame: median depth {z_med:.4f} m (plane at "
          f"{PLANE_CM / 100} m), launches {launches}, each exact against its plain version")

    # -- c. SfM --------------------------------------------------------------
    frames, centres = sfm_frames(rng)
    K = _k(0)
    sfm.build_tracks(frames[:2], K, SFM_CORNERS)  # the first call pays for the allocator
    (kp, track_of, n_tracks, matches), tracks_ms = timed(
        lambda: sfm.build_tracks(frames, K, SFM_CORNERS))
    (kp_c, _, n_tracks_c, matches_c), tracks_cpu_ms = timed(
        lambda: sfm.build_tracks(frames, K, SFM_CORNERS, device="cpu"))
    check(np.array_equal(kp, kp_c), "Harris corners differ between the card and the CPU")
    same = np.mean([np.array_equal(a[0][a[1]], b[0][b[1]]) and np.array_equal(a[1], b[1])
                    for a, b in zip(matches, matches_c)])
    print(f"phase 14 build_tracks: {tracks_ms:.1f} ms for {SFM_FRAMES} frames at {W}x{H}, "
          f"{SFM_CORNERS} corners (CPU {tracks_cpu_ms:.1f} ms); {n_tracks} tracks (CPU "
          f"{n_tracks_c}); corners equal, matches equal on {same:.3f} of the pairs")
    L, uv, lid, mask = sfm.observations(kp, track_of, n_tracks, 3)
    check(L >= 100, f"only {L} stable tracks")

    def chain(dev):
        return sfm.chain_poses(kp, matches, K, torch.Generator().manual_seed(1), device=dev)

    poses, chain_ms = timed(lambda: chain("cuda"))
    poses_c = chain("cpu")
    chain_err = rel(poses, poses_c)
    n_sync, where = sync_count(torch, lambda: sfm.chain_poses(
        kp[:2], matches[:1], K, torch.Generator().manual_seed(1), device="cuda"))
    lms = sfm.init_landmarks(poses, K, L, uv, lid, mask)
    intr = np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])
    _, _, rms0 = distributed_slam_ba(uv, lid, mask, intr, poses, lms,
                                     make_mesh(devices=["cuda:0"]), iters=0)
    ba = {}
    for n in (1, 4):
        mesh = make_mesh(devices=["cuda:0"] * n)
        distributed_slam_ba(uv, lid, mask, intr, poses, lms, mesh, iters=1)  # warm-up
        ba[n], ms = timed(lambda mesh=mesh: distributed_slam_ba(uv, lid, mask, intr, poses, lms,
                                                                mesh, iters=BA_ITERS))
        ba[n] = tuple(x.cpu().numpy() for x in ba[n]) + (ms / BA_ITERS,)
    ba_err = max(rel(a, b) for a, b in zip(ba[1][:2], ba[4][:2]))
    check(ba_err <= SFM_TOL, f"BA on 1 and 4 positions differs by {ba_err}")
    n_sync_ba, where_ba = sync_count(torch, lambda: distributed_slam_ba(
        uv, lid, mask, intr, poses, lms, make_mesh(devices=["cuda:0"] * 4), iters=BA_CHUNK))
    p_out, _, rms, _ = ba[1]
    check(float(rms) < float(rms0), f"BA RMS {float(rms)} not below its start {float(rms0)}")
    R_out = np.stack([_rodrigues_np(r) for r in p_out[:, :3]])
    centre_out = -np.einsum("fji,fj->fi", R_out, p_out[:, 3:])   # −Rᵀt
    step = np.abs(np.diff(centre_out, axis=0)).sum(axis=0)
    check(step[0] > step[1] + step[2], f"the camera centres' steps {step} are not mainly along x")
    ba_c = distributed_slam_ba(uv, lid, mask, intr, poses_c,
                               sfm.init_landmarks(poses_c, K, L, uv, lid, mask, device="cpu"),
                               make_mesh(devices=["cpu"]), iters=BA_ITERS)
    cpu_err = max(rel(a, b.numpy()) for a, b in zip(ba[1][:2], ba_c[:2]))
    print(f"phase 14 SfM: {L} landmarks over {SFM_FRAMES} frames; pose chain {chain_ms:.1f} ms "
          f"({chain_ms / (SFM_FRAMES - 1):.2f} ms a pair), card against CPU {chain_err:.2e}; "
          f"{n_sync} host syncs a RANSAC pair {where}; BA RMS {float(rms0):.4f} -> "
          f"{float(rms):.4f} px in {BA_ITERS} iterations, {ba[1][3]:.2f} ms an iteration on 1 "
          f"position, {ba[4][3]:.2f} on 4 (one card), 1 against 4 {ba_err:.2e}, card against "
          f"CPU {cpu_err:.2e}; {n_sync_ba} host syncs a BA chunk of {BA_CHUNK} on 4 positions "
          f"{where_ba}; steps |dx| {step[0]:.3f} |dy| {step[1]:.3f} |dz| {step[2]:.3f}")
    check(cpu_err <= SFM_TOL, f"the BA on the card differs from the CPU's by {cpu_err}")

    intr0, poses0 = mono_ba_init(obj, corners_l, size)
    (g, _, rms_m), mba_ms = timed(lambda: distributed_mono_ba(
        obj, corners_l, intr0, poses0, make_mesh(devices=["cuda:0"] * 4), iters=30))
    k_rel = rel(g.cpu().numpy()[:4], [ml["camera_matrix"][i] for i in ((0, 0), (1, 1), (0, 2),
                                                                          (1, 2))])
    check(float(rms_m) <= ml["reprojection_error"] * 1.01 and k_rel < 1e-4,
          f"distributed_mono_ba: RMS {float(rms_m)}, K {k_rel} from calibrate_camera's")
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 14 distributed_mono_ba (4 positions, 30 iterations): {mba_ms:.1f} ms, RMS "
          f"{float(rms_m):.4f} px (calibrate_camera {ml['reprojection_error']:.4f}), K within "
          f"{k_rel:.2e}; phase peak device memory {peak / 1e9:.2f} GB ({(peak - held) / 1e9:.2f} "
          f"GB its own), {time.perf_counter() - t_phase:.1f} s in all; card {card}")
    return launches, {"problem": (uv, lid, mask, intr, poses, lms),
                      "result": ba[1][:3]}


# -- phase 15: the serving daemon -------------------------------------------
SERVE_FRAMES = 4                   # stdin requests of a depth mode's run
SERVE_WATCH = 8                    # pairs in the hot folder: one batch of 8
SERVE_FUSED = 4                    # fused-mode requests
SERVE_DT = 1.0 / 30.0              # the fused run's fixed clock step (s)
SERVE_RANGE = (0.3, 10.0)          # the depth window set mid-stream (m)
# the kernels a served request of each depth mode must launch
SERVE_KERNELS = {"hier": ("census_words", "cost_volume", "aggregate_dual", "sum_wta",
                          "right_disparity", "shift_gather", "speckle_counts"),
                 "prod": tuple(KERNELS)}


def write_pgm(path, img) -> None:
    """A binary 8-bit PGM (``P5``), the format ``io.frames`` decodes itself."""
    img = np.ascontiguousarray(img, np.uint8)
    path.write_bytes(f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode() + img.tobytes())


def serve_run(torch, serve, sgm_cuda, argv, requests, probes=None, clock=None):
    """``apps.serve.main(argv)`` over JSON-lines ``requests`` → (responses,
    probed): the request whose id ``probes`` maps to "launches" is
    dispatched with the launch counts set to 0 just before and read just
    after, its kernel calls recorded; the one mapped to "syncs" under
    :func:`sync_count`. ``clock`` replaces serve's ``time.monotonic``."""
    import io
    import types

    probes, probed = probes or {}, {}
    dispatch = serve._Server.dispatch
    targets = [(sgm_cuda, name) for name in (*KERNELS, *NAMED_KERNELS)]

    def probing(self, req):
        kind = probes.get(req.get("id"))
        if kind == "launches":
            torch.cuda.synchronize()
            sgm_cuda.reset_launch_counts()
            with Recorder(torch, targets) as rec:
                rec_out = dispatch(self, req)
            torch.cuda.synchronize()
            probed["launches"] = ({k: n for k, n in sgm_cuda.launch_counts().items() if n},
                                  rec.calls)
            return rec_out
        if kind == "syncs":
            box = {}
            probed["syncs"] = sync_count(torch, lambda: box.setdefault("out", dispatch(self, req)))
            return box["out"]
        return dispatch(self, req)

    saved_time = serve.time
    serve._Server.dispatch = probing
    if clock is not None:
        serve.time = types.SimpleNamespace(perf_counter=time.perf_counter, sleep=time.sleep,
                                           monotonic=clock)
    out = io.StringIO()
    try:
        rc = serve.main(argv, stdin=io.StringIO("\n".join(requests) + "\n"), stdout=out)
    finally:
        serve._Server.dispatch = dispatch
        serve.time = saved_time
    check(rc == 0, f"serve {argv} exited with {rc}")
    resps = [json.loads(line) for line in out.getvalue().splitlines()]
    bad = [r for r in resps if not r.get("ok")]
    check(not bad, f"serve {argv}: failed responses {bad}")
    return resps, probed


def served_equal(resps, direct, what: str, keys) -> None:
    """Each served response's npz against the direct pipeline's arrays for
    the same request (``direct``: id → {key: numpy}), bit for bit."""
    served = {r["id"]: r for r in resps if "out_npz" in r}
    check(sorted(served) == sorted(direct), f"{what}: served ids {sorted(served)}, "
                                            f"not {sorted(direct)}")
    for rid, want in direct.items():
        got = np.load(served[rid]["out_npz"])
        for key in keys:
            check(got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]),
                  f"{what}: request {rid}'s {key} differs from the direct pipeline's")


def serve_phase(torch, card: str, cal, planes):
    """Phase 15, ``apps.serve`` on the card at full width: a calibration
    store of the identity 720p rig and binary PGM pairs of the production
    rig (uint8, panning 1 px a pair), written here:

    a. depth mode with serve's defaults (``hier``, D=320, refine 32):
       SERVE_FRAMES requests, ``ping``, ``set`` (the depth window), a
       request, ``rescale 0.5``, a request at 640x360, ``stats``,
       ``shutdown``; then ``--sgm-mode prod``; then ``--watch --once
       --batch 8`` over SERVE_WATCH pairs (one batched dispatch); each
       served npz bit for bit against the same pipeline built and called
       directly on the same frames;
    b. one request of each depth mode recorded (counts set to 0 just before
       its dispatch, read just after: every kernel of the mode must launch)
       and its launches replayed against their plain versions (exact); the
       synchronising calls of one ``dispatch`` of each mode;
    c. fused mode at ``--scale 0.33`` on phase 12's frames, serve's clock
       fixed, bit for bit against ``FusedPipeline`` called directly with
       the same ``t_now``; one dispatch's synchronising calls;
    d. prints each request's ms, ``fps`` and ``wall_fps``, syncs a dispatch
       and peak device memory beside the card.

    Returns the launches of one served request by mode ("hier", "prod")."""
    import shutil
    import tempfile
    from pathlib import Path

    from stereovision_tpu_torch.apps import serve
    from stereovision_tpu_torch.io.frames import imread_gray
    from stereovision_tpu_torch.io.store import CalibrationStore
    from stereovision_tpu_torch.ops import sgm_cuda
    from stereovision_tpu_torch.pipeline import DepthPipeline, FusedPipeline

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    try:
        calib = root / "calib"
        CalibrationStore(calib).save("stereo_calibration_data", cal)
        left, right = (np.clip(np.rint(p), 0, 255).astype(np.uint8) for p in planes)
        frames = root / "frames"
        frames.mkdir()
        n_pairs = max(SERVE_FRAMES + 2, SERVE_WATCH)
        pair_paths = []
        for k in range(n_pairs):
            lp, rp = frames / f"left_{k:03d}.pgm", frames / f"right_{k:03d}.pgm"
            write_pgm(lp, np.roll(left, k, 1))
            write_pgm(rp, np.roll(right, k, 1))
            pair_paths.append((lp, rp))
        watch = root / "watch"
        watch.mkdir()
        for lp, rp in pair_paths[:SERVE_WATCH]:
            shutil.copy(lp, watch / lp.name)
            shutil.copy(rp, watch / rp.name)

        def req(k, rid, out):
            return json.dumps({"left": str(pair_paths[k][0]), "right": str(pair_paths[k][1]),
                               "id": rid, "out": str(root / out)})

        def read(k):
            return imread_gray(pair_paths[k][0]), imread_gray(pair_paths[k][1])

        def depth_arrays(pipe, k):
            res = pipe(*read(k))
            return {"disparity": res.disparity.cpu().numpy(),
                    "valid": res.confidence.cpu().numpy().astype(bool),
                    "depth_m": res.depth_m.cpu().numpy()}

        base = ["--calib", str(calib), "--num-disparities", str(D), "--save-npz"]
        keys = ("disparity", "valid", "depth_m")
        probed, ms, stats = {}, {}, {}
        # -- a/b. depth mode, serve's defaults (hier) ------------------------
        reqs = [req(k, k + 1, "hier") for k in range(SERVE_FRAMES)]
        reqs += [json.dumps({"cmd": "ping"}),
                 json.dumps({"cmd": "set", "params": dict(zip(("min_depth", "max_depth"),
                                                              SERVE_RANGE))}),
                 req(SERVE_FRAMES, SERVE_FRAMES + 1, "hier"),
                 json.dumps({"cmd": "rescale", "scale": 0.5}),
                 req(SERVE_FRAMES + 1, SERVE_FRAMES + 2, "hier_half"),
                 json.dumps({"cmd": "stats"}), json.dumps({"cmd": "shutdown"})]
        resps, probed["hier"] = serve_run(torch, serve, sgm_cuda, base, reqs,
                                          {2: "launches", 3: "syncs"})
        check(any(r.get("pong") for r in resps), "serve: no pong")
        check([r["depth_range"] for r in resps if "depth_range" in r] == [list(SERVE_RANGE)],
              "serve: the depth window was not set")
        check([r["proc_size"] for r in resps if "proc_size" in r] == [[W // 2, H // 2]],
              "serve: rescale 0.5 did not take the processing size to half")
        pipe = DepthPipeline.from_store(calib, num_disparities=D, mode="hier", refine_range=32)
        direct = {k + 1: depth_arrays(pipe, k) for k in range(SERVE_FRAMES)}
        pipe.set_depth_range(*SERVE_RANGE)
        direct[SERVE_FRAMES + 1] = depth_arrays(pipe, SERVE_FRAMES)
        half = DepthPipeline.from_store(calib, num_disparities=D, mode="hier", refine_range=32,
                                        proc_scale=0.5)
        direct[SERVE_FRAMES + 2] = depth_arrays(half, SERVE_FRAMES + 1)
        del half
        served_equal(resps, direct, "serve hier", keys)
        ms["hier"] = [r["ms"] for r in resps if "out_npz" in r]
        stats["hier"] = resps[-1]
        # --sgm-mode prod
        reqs = [req(k, k + 1, "prod") for k in range(SERVE_FRAMES - 1)] + [
            json.dumps({"cmd": "stats"})]
        resps, probed["prod"] = serve_run(torch, serve, sgm_cuda, base + ["--sgm-mode", "prod"],
                                          reqs, {2: "launches", 3: "syncs"})
        prod = DepthPipeline.from_store(calib, num_disparities=D, mode="prod")
        served_equal(resps, {k + 1: depth_arrays(prod, k) for k in range(SERVE_FRAMES - 1)},
                     "serve prod", keys)
        del prod
        ms["prod"] = [r["ms"] for r in resps if "out_npz" in r]
        stats["prod"] = resps[-1]
        # --watch --once --batch 8: one batched dispatch of SERVE_WATCH pairs
        resps, _ = serve_run(torch, serve, sgm_cuda, base + [
            "--watch", str(watch), "--once", "--batch", str(SERVE_WATCH),
            "--out", str(root / "watched")], [])
        check(resps[-1]["frames"] == SERVE_WATCH, f"watch mode served {resps[-1]['frames']} "
                                                  f"pairs, not {SERVE_WATCH}")
        pipe.set_depth_range(0.2, 4.0)   # the pipeline's defaults, as the watcher's
        for k in range(SERVE_WATCH):
            got = np.load(root / "watched" / f"serve_{k:03d}.npz")
            want = depth_arrays(pipe, k)
            for key in keys:
                check(np.array_equal(got[key], want[key]),
                      f"serve watch: pair {k}'s {key} differs from the direct pipeline's")
        ms["watch"] = [r["ms"] for r in resps[:-1]]
        stats["watch"] = resps[-1]
        del pipe
        launches = {}
        for mode in ("hier", "prod"):
            counts, calls = probed[mode]["launches"]
            for k in SERVE_KERNELS[mode]:
                check(counts.get(k, 0) > 0, f"serve {mode}: kernel {k} was not launched in one "
                                            f"served request ({counts})")
            check(not counts.get("aggregate_dual_chain"), f"serve {mode}: chain launches")
            parity(torch, sgm_cuda, {k: v for k, v in calls.items() if v}, f"served {mode} request")
            launches[mode] = counts
            del calls
        # -- c. fused mode ---------------------------------------------------
        fused_dir = root / "fused"
        fused_dir.mkdir()
        fused_paths = []
        for k, (fl, fr) in enumerate(fused_frames(planes, SERVE_FUSED)):
            lp, rp = fused_dir / f"left_{k:03d}.pgm", fused_dir / f"right_{k:03d}.pgm"
            write_pgm(lp, fl)
            write_pgm(rp, fr)
            fused_paths.append((lp, rp))
        reqs = [json.dumps({"left": str(lp), "right": str(rp), "id": k + 1,
                            "out": str(root / "fused_out")})
                for k, (lp, rp) in enumerate(fused_paths)] + [json.dumps({"cmd": "stats"})]
        ticks = iter(SERVE_DT * k for k in range(10 * SERVE_FUSED))
        resps, probed["fused"] = serve_run(
            torch, serve, sgm_cuda, base + ["--mode", "fused", "--scale", str(FUSED_SCALE)],
            reqs, {3: "syncs"}, clock=lambda: next(ticks))
        fpipe = FusedPipeline.from_store(calib, scale=FUSED_SCALE)
        direct = {}
        for k, (lp, rp) in enumerate(fused_paths):
            out = fpipe(imread_gray(lp), imread_gray(rp), t_now=SERVE_DT * k)
            direct[k + 1] = {key: out[key].cpu().numpy() for key in ("fused", "confidence",
                                                                    "meters")}
            served = next(r for r in resps if r.get("id") == k + 1)
            check((served["fusion_mode"], served["occlusion"], served["camera_moving"])
                  == (int(out["mode"]), out["occlusion"], bool(out["camera_moving"])),
                  f"serve fused: request {k + 1}'s mode, occlusion or motion differs")
        served_equal(resps, direct, "serve fused", ("fused", "confidence", "meters"))
        del fpipe
        ms["fused"] = [r["ms"] for r in resps if "out_npz" in r]
        stats["fused"] = resps[-1]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated()
    for mode in ("hier", "prod"):
        print(f"phase 15 served {mode} request: launches {launches[mode]}, each exact against "
              f"its plain version; {probed[mode]['syncs'][0]} synchronising calls a dispatch "
              f"{probed[mode]['syncs'][1]}")
    print(f"phase 15 served fused request: {probed['fused']['syncs'][0]} synchronising calls a "
          f"dispatch {probed['fused']['syncs'][1]}")
    for mode, times in ms.items():
        s = stats[mode]
        print(f"phase 15 serve {mode} at {W}x{H}"
              + (f" (D={D})" if mode != "fused" else f" (scale {FUSED_SCALE})")
              + f": ms a request {times}; stats mean_ms {s['mean_ms']}, fps {s['fps']}, "
              f"wall_fps {s['wall_fps']} over {s['frames']} frames; served arrays equal the "
              f"direct pipeline's bit for bit; card {card}")
    print(f"phase 15: peak device memory {peak / 1e9:.2f} GB ({(peak - held) / 1e9:.2f} GB its "
          f"own), {time.perf_counter() - t_phase:.1f} s in all; card {card}")
    return launches


# -- phase 16: MidasSmall's synthetic pretraining ----------------------------
TRAIN_STEPS = 20                   # train_synthetic.main's steps at its defaults
TRAIN_TIMED = 10                   # steps timed with events after 2 warm-up steps
# card against CPU, one step: a leaf's gradient within TRAIN_TOL of its own
# largest magnitude plus TRAIN_TOL_ALL of the largest over every leaf. A leaf
# the loss barely depends on is rounding noise in float32 (the head's bias
# under the scale-and-shift alignment: 13% from float64 on the CPU), so the
# leaf's own scale alone cannot hold it; float32 against float64 on the CPU
# reads 0.33 of this bound at the phase's batch.
TRAIN_TOL, TRAIN_TOL_ALL = 2e-2, 2e-3


def train_phase(torch, card: str):
    """Phase 16, ``models.train_synthetic`` on the card at the reference's
    width (size 128, batch 16, lr 3e-4): ``main`` for TRAIN_STEPS steps
    (initial and final validation loss finite; its checkpoint read back
    through ``mono.nn.create_model`` to the saved arrays, the network's
    output finite); TRAIN_TIMED steps timed with events (ms/step) and
    their losses finite; one step from the same seeded state on the card
    and on the CPU with TF32 off: the loss within 1e-5 relative, each
    variable's gradient within TRAIN_TOL of its largest magnitude on the
    CPU plus TRAIN_TOL_ALL of the largest over all variables; peak device
    memory."""
    import contextlib
    import io
    import tempfile
    from pathlib import Path

    from stereovision_tpu_torch import convert
    from stereovision_tpu_torch.models import train_synthetic as ts
    from stereovision_tpu_torch.models.checkpoint import load_variables
    from stereovision_tpu_torch.models.synthetic_scenes import batch as make_batch
    from stereovision_tpu_torch.mono import nn

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        out = Path(tmp) / "midas_synthetic.msgpack"
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            rc = ts.main(["--steps", str(TRAIN_STEPS), "--out", str(out)])
        main_s = time.perf_counter() - t0
        lines = text.getvalue().splitlines()
        check(rc == 0 and lines[0].startswith("initial val loss") and "saved" in lines[-1],
              f"train_synthetic.main: {lines}")
        val0, val1 = float(lines[0].split()[-1]), float(lines[-1].split()[-1])
        check(np.isfinite(val0) and np.isfinite(val1), f"validation loss {val0} -> {val1}")
        saved, nn.PRETRAINED = nn.PRETRAINED, out
        try:
            model = nn.create_model(device="cuda")
        finally:
            nn.PRETRAINED = saved
        want = convert.midas_small_from_flax(load_variables(out))
        got = model.state_dict()
        check(all(torch.equal(got[k].cpu(), want[k]) for k in want),
              "the trained checkpoint does not read back through create_model")
        probe = torch.as_tensor(make_batch(np.random.default_rng(1), 2, 128)[0] / 255.0,
                                device="cuda")
        with torch.no_grad():
            check(bool(torch.isfinite(model(probe)).all()), "the trained network's output")
    peak = torch.cuda.max_memory_allocated()
    # ms/step: TRAIN_TIMED steps of batches made and uploaded ahead
    rng = np.random.default_rng(2)
    model = nn.create_model(pretrained=False, seed=0)
    variables = ts.trainable_variables(model)
    opt = ts.make_optimizer(variables, 3e-4)
    batches = [tuple(torch.as_tensor(a, device="cuda") for a in make_batch(rng, 16, 128))
               for _ in range(TRAIN_TIMED + 2)]
    losses = [ts.train_step(model, variables, opt, *b) for b in batches[:2]]
    steps = iter(batches[2:])
    step_ms = cuda_ms(torch, lambda: losses.append(ts.train_step(model, variables, opt,
                                                                 *next(steps))),
                      TRAIN_TIMED, warmup=0)
    check(all(bool(torch.isfinite(v)) for v in losses), f"training losses {losses}")
    # one step from the same seeded state, card against CPU (TF32 off)
    imgs, invd = make_batch(np.random.default_rng(5), 16, 128)
    grads, loss = {}, {}
    for dev in ("cuda", "cpu"):
        m = nn.create_model(pretrained=False, seed=0, device=dev)
        v = ts.trainable_variables(m)
        loss[dev] = float(ts.train_step(m, v, ts.make_optimizer(v, 3e-4),
                                        torch.as_tensor(imgs, device=dev),
                                        torch.as_tensor(invd, device=dev)))
        grads[dev] = {k: t.grad.cpu() for k, t in v.items()}
    loss_err = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
    scale = max(float(g.abs().max()) for g in grads["cpu"].values())
    grad_err = max(float((grads["cuda"][k] - g).abs().max())
                   / (TRAIN_TOL * float(g.abs().max()) + TRAIN_TOL_ALL * scale)
                   for k, g in grads["cpu"].items())
    check(loss_err <= 1e-5 and grad_err <= 1.0,
          f"a training step on the card against the CPU: loss {loss_err}, gradients at "
          f"{grad_err} of their bound")
    print(f"phase 16 train_synthetic.main (size 128, batch 16, {TRAIN_STEPS} steps): "
          f"{main_s:.1f} s with its validations, val loss {val0:.5f} -> {val1:.5f}; "
          f"{step_ms:.2f} ms/step ({TRAIN_TIMED} steps, events, batches uploaded ahead), losses "
          f"{float(losses[0]):.5f} -> {float(losses[-1]):.5f}; card against CPU (TF32 off): "
          f"loss {loss_err:.2e} relative, gradients at {grad_err:.3f} of their bound "
          f"({TRAIN_TOL} of a leaf's largest + {TRAIN_TOL_ALL} of all leaves' largest); the "
          f"checkpoint reads back through create_model; peak device memory {peak / 1e9:.2f} GB "
          f"({(peak - held) / 1e9:.2f} GB its own); {time.perf_counter() - t_phase:.1f} s in "
          f"all; card {card}")
    return step_ms


# -- phase 17: a mesh across processes on one card --------------------------
MH_TIMEOUT_S = 420                 # each child process's time limit
MH_HALO = 23
MH_EXACT_FRAMES = 2                # frames of each exact strategy across the processes
MH_CHECKS = ["psum", "halo_exchange", "sharded_disparity", "sharded_disparity_exact",
             "sharded_disparity_exact_pipelined", "distributed_slam_ba"]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multihost_child(rank: int, port: int, tmp: str) -> int:
    """One rank of phase 17's two-process gloo group on cuda:0: ``psum``,
    ``halo_exchange``, ``sharded_disparity`` (``production_preset()`` at
    720x1280 on two row tiles) and the exact engine's two strategies
    (``SGMParams(num_disparities=320)`` on MH_EXACT_FRAMES frames, two row
    tiles; counted: this process's tile launches the chain T times a frame,
    or B + T - 1 times a run, and ``sum_wta`` once a frame) across the
    processes, each equal bit for bit to the same call on a one-process
    mesh of two positions of the card, and ``distributed_slam_ba`` on phase
    14's problem (frames across the processes) within SFM_TOL of the
    one-process mesh's. Prints one JSON line."""
    import torch

    from stereovision_tpu_torch.ops import sgm_cuda
    from stereovision_tpu_torch.parallel import (distributed_slam_ba, make_mesh,
                                                 sharded_disparity, sharded_disparity_exact,
                                                 sharded_disparity_exact_pipelined)
    from stereovision_tpu_torch.parallel import mesh as pmesh
    from stereovision_tpu_torch.stereo import SGMParams, production_preset

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pmesh.initialize_multihost(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    out = {"rank": rank, "device": str(pmesh._PROCESS["device"])}
    frames, tiles = make_mesh(), make_mesh(frame=1, tile=2)
    one_f = make_mesh(devices=["cuda:0"] * 2)
    one_t = make_mesh(frame=1, tile=2, devices=["cuda:0"] * 2)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    parts = [torch.randn((H, W), generator=gen, device="cuda") for _ in range(2)]
    got = pmesh.psum({rank: parts[rank]}, frames.frame_axis())[rank]
    check(torch.equal(got, pmesh.psum(parts)[rank]), "psum across processes")
    slabs = [torch.randn((H // 2, W), generator=gen, device="cuda") for _ in range(2)]
    got = pmesh.halo_exchange([s if k == rank else None for k, s in enumerate(slabs)], MH_HALO,
                              tiles.tile_axis(0))[rank]
    check(torch.equal(got, pmesh.halo_exchange(slabs, MH_HALO)[rank]),
          "halo_exchange across processes")
    left, right = two_plane_pair()
    t0 = time.perf_counter()
    disp, valid = sharded_disparity(left[None], right[None], production_preset(), tiles)
    torch.cuda.synchronize()
    out["sharded_ms"] = (time.perf_counter() - t0) * 1e3
    disp1, valid1 = sharded_disparity(left[None], right[None], production_preset(), one_t)
    check(torch.equal(disp, disp1) and torch.equal(valid, valid1),
          "sharded_disparity across processes differs from the one-process mesh's")
    t0 = time.perf_counter()
    disp, valid = sharded_disparity(left[None], right[None], production_preset(), tiles)
    torch.cuda.synchronize()
    out["sharded_ms_again"] = (time.perf_counter() - t0) * 1e3
    pairs = [flat_pair(SEED + 20 + i) for i in range(MH_EXACT_FRAMES)]
    lefts, rights = np.stack([a for a, _ in pairs]), np.stack([b for _, b in pairs])
    p = SGMParams(num_disparities=D)
    for fn, chain in ((sharded_disparity_exact, 2 * MH_EXACT_FRAMES),
                      (sharded_disparity_exact_pipelined, MH_EXACT_FRAMES + 1)):
        name = fn.__name__
        sgm_cuda.reset_launch_counts()
        got, ms = host_timed(torch, lambda: fn(lefts, rights, p, tiles))
        counts = sgm_cuda.launch_counts()
        check(counts["aggregate_dual_chain"] == chain and counts["sum_wta"] == MH_EXACT_FRAMES,
              f"{name} across processes, rank {rank}: launches {counts}")
        out[f"{name}_ms_first"] = ms / MH_EXACT_FRAMES
        _, ms = host_timed(torch, lambda: fn(lefts, rights, p, tiles))
        out[f"{name}_ms"] = ms / MH_EXACT_FRAMES
        want = fn(lefts, rights, p, one_t)
        check(all(torch.equal(g, w) for g, w in zip(got, want)) and got[0].shape == (
            MH_EXACT_FRAMES, H, W), f"{name} across processes differs from the one-process mesh's")
        del got, want
    torch.cuda.empty_cache()
    z = np.load(f"{tmp}/ba.npz")
    problem = tuple(z[k] for k in ("uv", "lid", "mask", "intr", "poses", "lms"))
    t0 = time.perf_counter()
    ba = distributed_slam_ba(*problem, frames, iters=BA_ITERS)
    torch.cuda.synchronize()
    out["ba_ms"] = (time.perf_counter() - t0) * 1e3
    ba1 = distributed_slam_ba(*problem, one_f, iters=BA_ITERS)
    out["ba_err"] = max(rel(a.cpu().numpy(), b.cpu().numpy()) for a, b in zip(ba[:2], ba1[:2]))
    check(out["ba_err"] <= SFM_TOL, f"distributed_slam_ba across processes: {out['ba_err']}")
    out["checked"] = MH_CHECKS
    print(json.dumps(out))
    pmesh.shutdown_multihost()
    return 0


def multihost_phase(torch, card: str, ba):
    """Phase 17, ``initialize_multihost`` and meshes across processes:

    a. in this process, a one-process group over NCCL (cuda:0):
       ``make_mesh()`` spans it; ``psum`` through NCCL's all-gather equals
       the one-process sum; ``distributed_slam_ba`` on phase 14's problem
       (BA_ITERS iterations) within SFM_TOL of phase 14's 1-position result,
       timed;
    b. two child processes in a gloo group, sharing the card
       (:func:`multihost_child`), each under MH_TIMEOUT_S: a failure or a
       timeout in either fails the phase."""
    import os
    import tempfile

    from stereovision_tpu_torch.parallel import distributed_slam_ba, make_mesh
    from stereovision_tpu_torch.parallel import mesh as pmesh

    t_phase = time.perf_counter()
    pmesh.initialize_multihost(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        import torch.distributed as dist

        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1, "the NCCL group")
        mesh = make_mesh()
        check(mesh.ranks == ((0,),) and mesh.home == pmesh._PROCESS["device"], f"mesh {mesh}")
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        part = torch.randn((H, W), generator=gen, device="cuda")
        got = pmesh.psum({0: part}, mesh.frame_axis())[0]
        check(torch.equal(got, pmesh.psum([part])[0]), "psum through NCCL")
        distributed_slam_ba(*ba["problem"], mesh, iters=1)   # warm-up
        out, ba_ms = host_timed(torch, lambda: distributed_slam_ba(*ba["problem"], mesh,
                                                                   iters=BA_ITERS))
        ba_err = max(rel(a.cpu().numpy(), b) for a, b in zip(out[:2], ba["result"][:2]))
        check(ba_err <= SFM_TOL, f"distributed_slam_ba through NCCL: {ba_err} from phase 14's")
    finally:
        pmesh.shutdown_multihost()
    print(f"phase 17 one-process NCCL group on {mesh.home}: psum exact; distributed_slam_ba "
          f"{ba_ms:.1f} ms for "
          f"{BA_ITERS} iterations, {ba_err:.2e} from phase 14's 1-position result; card {card}")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mh_") as tmp:
        uv, lid, mask, intr, poses, lms = ba["problem"]
        np.savez(f"{tmp}/ba.npz", uv=uv, lid=lid, mask=mask, intr=intr, poses=poses, lms=lms)
        port = _free_port()
        env = dict(os.environ, PYTHONUNBUFFERED="1")
        procs = [subprocess.Popen([sys.executable, __file__, "--multihost-rank", str(r), str(port),
                                   tmp], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True, env=env) for r in range(2)]
        results = []
        try:
            for r, p in enumerate(procs):
                try:
                    so, se = p.communicate(timeout=MH_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    raise RuntimeError(f"chip_smoke check failed: phase 17 rank {r} ran past "
                                       f"{MH_TIMEOUT_S} s")
                check(p.returncode == 0, f"phase 17 rank {r} exited with {p.returncode}: "
                                         f"{se[-3000:]}")
                results.append(json.loads(so.strip().splitlines()[-1]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for res in results:
        check(res["checked"] == MH_CHECKS, f"phase 17 rank {res['rank']}: {res}")
    print(f"phase 17 two processes over gloo on one card ({[r['device'] for r in results]}): "
          f"psum, halo_exchange and sharded_disparity (production, {W}x{H}, 2 row tiles) equal "
          f"the one-process mesh's bit for bit; sharded_disparity "
          f"{[round(r['sharded_ms'], 1) for r in results]} ms (first), "
          f"{[round(r['sharded_ms_again'], 1) for r in results]} ms (again) on the host's "
          f"clock; the exact engine ({MH_EXACT_FRAMES} frames, D={D}, 2 row tiles, bit for bit) "
          + "; ".join(f"{k[:-3]} {[round(r[k], 1) for r in results]} ms a frame warm, "
                      f"{[round(r[k + '_first'], 1) for r in results]} first"
                      for k in ("sharded_disparity_exact_ms",
                                "sharded_disparity_exact_pipelined_ms"))
          + f"; distributed_slam_ba {[round(r['ba_ms'], 1) for r in results]} ms, "
          f"{max(r['ba_err'] for r in results):.2e} from the one-process mesh's; "
          f"{time.perf_counter() - t_phase:.1f} s in all; card {card}")


# -- phase 18: the quality evaluations ---------------------------------------
# the JAX reference's scores on the same scenes (seed 42, 1280x720, D=320):
# ``JAX_PLATFORMS=cpu python scripts/eval_quality.py --modes prod`` and
# ``--modes full`` on an x86 CPU (JAX 0.9.0, float32; cv2 5.0.0), as printed
# (rounded to 1e-4): scene → mode → (bad2, epe, d1_all)
QUALITY_REF = {
    "boxes": {"prod": (0.0053, 0.4331, 0.0052), "full": (0.0020, 0.0139, 0.0020),
              "cv2": (0.0052, 0.3169, 0.0052)},
    "slant": {"prod": (0.0001, 0.1301, 0.0001), "full": (0.0065, 0.0630, 0.0065),
              "cv2": (0.2440, 0.0788, 0.2440)},
    "steps": {"prod": (0.0012, 0.0721, 0.0011), "full": (0.0020, 0.0120, 0.0020),
              "cv2": (0.0045, 0.1132, 0.0045)},
    "gain": {"prod": (0.0058, 0.4854, 0.0057), "full": (0.0026, 0.0179, 0.0026),
             "cv2": (0.0096, 0.4650, 0.0096)},
}
# the port's scores against those: the scenes differ by the blur's float32
# rounding only (eval_quality.gaussian_blur_5 for cv2.GaussianBlur), so the
# engines see the same pairs up to that; bad2 and d1_all are fractions
# (0.05 percentage points), epe in px
QUALITY_TOL = {"bad2": 5e-4, "epe": 0.01, "d1_all": 5e-4}
QUALITY_MODES = {"prod": tuple(KERNELS),
                 "full": ("census_words", "cost_volume", "aggregate_dual", "right_disparity",
                          "shift_gather", "speckle_counts", "sum_wta")}
MONO_N = 4                         # eval_mono's held-out scenes
MONO_REL = 1e-4                    # ssi_rmse_rel, card against the CPU, TF32 off


def quality_phase(torch, card: str):
    """Phase 18, the quality evaluations of ``stereovision_tpu_torch.scripts``
    at 1280x720, D=320, uncut:

    a. ``eval_quality``'s four scenes (seed 42) in modes ``prod`` and
       ``full``: on ``boxes`` each mode's frame is recorded (every launch
       exact against its plain version), counted (every kernel of the mode
       launched) and held against its plain-kernel twin (``impl="xla"``:
       valid exact, disparity within 1e-4 px); every scene's bad2, EPE and
       D1 within QUALITY_TOL of the JAX reference's (QUALITY_REF); the cv2
       recipe where cv2 imports; ms a scene and mode (events, host
       included);
    b. ``eval_speckle``'s rows at ``hier2``: the pixels each filter removed
       equal the plain-kernel twin's;
    c. ``eval_mono``'s rows with the bundled MidasSmall (MONO_N scenes):
       ``ssi_rmse_rel`` on the card within MONO_REL of the CPU's.

    Returns each mode's launches on the boxes frame."""
    from stereovision_tpu_torch.mono.nn import create_model
    from stereovision_tpu_torch.ops import sgm_cuda
    from stereovision_tpu_torch.scripts import eval_mono, eval_quality, eval_speckle
    from stereovision_tpu_torch.stereo import compute_disparity, reference_preset
    from stereovision_tpu_torch.stereo.eval import evaluate_disparity

    t_phase = time.perf_counter()
    targets = [(sgm_cuda, n) for n in (*KERNELS, *NAMED_KERNELS)]
    launches, rows = {}, []
    for scene, render in eval_quality.SCENES.items():
        left, right, gt, gt_valid = render(np.random.default_rng(42), H, W, D)
        for mode, must in QUALITY_MODES.items():
            if scene == "boxes":
                with Recorder(torch, targets) as rec:
                    sgm_cuda.reset_launch_counts()
                    disp, valid, _ = eval_quality.run_ours(left, right, mode)
                    launches[mode] = sgm_cuda.launch_counts()
                parity(torch, sgm_cuda, rec.calls, f"quality {scene} {mode}")
                del rec
                for k in must:
                    check(launches[mode][k] > 0, f"quality {mode}: kernel {k} was not launched")
                d_x, v_x = (t.cpu().numpy() for t in compute_disparity(
                    left, right, dataclasses.replace(eval_quality.params_for(mode), impl="xla")))
                d_err = float(np.abs(disp - d_x).max())
                check(np.array_equal(valid, v_x) and d_err <= 1e-4,
                      f"quality {scene} {mode}: the plain-kernel twin differs ({d_err} px)")
                print(f"quality {scene} {mode}: launches {launches[mode]}; equal to its "
                      f"plain-kernel twin (valid exact, disparity {d_err} px)")
            else:
                disp, valid, _ = eval_quality.run_ours(left, right, mode)
            ms = cuda_ms(torch, lambda: eval_quality.run_ours(left, right, mode), 3)
            m = evaluate_disparity(disp, gt, valid=valid, gt_valid=gt_valid)
            want = dict(zip(("bad2", "epe", "d1_all"), QUALITY_REF[scene][mode]))
            off = {k: abs(m[k] - want[k]) for k in QUALITY_TOL}
            check(all(off[k] <= QUALITY_TOL[k] for k in off),
                  f"quality {scene} {mode}: {m} against the reference's {want}")
            rows.append({"scene": scene, "engine": f"ours_{mode}", "ms": ms, **m})
            print(f"quality {scene} {mode}: bad2 {m['bad2']:.6f}, epe {m['epe']:.6f}, d1_all "
                  f"{m['d1_all']:.6f}, coverage {m['coverage']:.6f} (the reference's on the CPU "
                  f"{want}; off by {off}); {ms:.3f} ms a scene (events, host included), card "
                  f"{card}")
        ref = eval_quality.run_reference(left, right, D)
        if ref is None:
            print("quality " + json.dumps({"scene": scene, "engine": "cv2_sgbm_3way",
                                           "skipped": "cv2 is not installed"}))
        else:
            m = evaluate_disparity(ref[0], gt, valid=ref[1], gt_valid=gt_valid)
            print(f"quality {scene} cv2_sgbm_3way on this host: bad2 {m['bad2']:.6f}, epe "
                  f"{m['epe']:.6f}, d1_all {m['d1_all']:.6f}, {ref[2] * 1e3:.1f} ms")
    print("quality rows " + json.dumps([{k: (round(v, 6) if isinstance(v, float) else v)
                                         for k, v in r.items()} for r in rows]))

    p_win = reference_preset(mode="hier2")
    for scene, render in eval_quality.SCENES.items():
        args = render(np.random.default_rng(42), H, W, D)
        t0 = time.perf_counter()
        row = eval_speckle.speckle_row(scene, *args, p_win)
        s_ms = (time.perf_counter() - t0) * 1e3
        twin = eval_speckle.speckle_row(scene, *args, dataclasses.replace(p_win, impl="xla"))
        for k in ("exact_removed", "windowed_removed"):
            check(row[k] == twin[k], f"eval_speckle {scene}: {k} {row[k]}, the plain-kernel "
                                     f"twin's {twin[k]}")
        print(f"eval_speckle {json.dumps(row)}; removed pixels equal the plain-kernel twin's; "
              f"{s_ms:.1f} ms (both engines and the native fill, host clock)")

    got = {}
    for dev in ("cuda", "cpu"):
        model = create_model("small", device=dev)
        t0 = time.perf_counter()
        got[dev] = eval_mono.mono_rows(model, "small", MONO_N, device=dev, digits=None)
        if dev == "cuda":
            torch.cuda.synchronize()
            m_ms = (time.perf_counter() - t0) * 1e3
    for g, c in zip(got["cuda"], got["cpu"]):
        err = abs(g["ssi_rmse_rel"] - c["ssi_rmse_rel"]) / abs(c["ssi_rmse_rel"])
        check(err <= MONO_REL, f"eval_mono {g['dataset']}: card {g}, CPU {c}")
        print(f"eval_mono {g['dataset']}: ssi_rmse_rel {g['ssi_rmse_rel']:.6f}, delta_1.25 "
              f"{g['delta_1.25']:.6f} (CPU {c['ssi_rmse_rel']:.6f}, {c['delta_1.25']:.6f}; "
              f"{err:.2e} relative)")
    print(f"phase 18 quality: four scenes x (prod, full) within the reference's scores, the "
          f"boxes frames exact against their plain versions and twins; eval_speckle and "
          f"eval_mono rows checked (eval_mono {m_ms:.1f} ms on the card for {MONO_N} + 2 "
          f"scenes); {time.perf_counter() - t_phase:.1f} s in all; card {card}")
    return launches


def rel(a, b) -> float:
    """max |a − b| over max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def host_timed(torch, fn):
    """(fn(), its ms on the host's clock, the card synchronised before and
    after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def calib_run(torch, name, run, card):
    """One calibration on the card (LM iterations counted and timed) and the
    same call on the CPU: K, dist, R, T within CALIB_TOL relative."""
    trace = []
    out, ms = host_timed(torch, lambda: run("cuda", trace))
    ref = run("cpu", None)
    keys = [k for k in ("camera_matrix", "distortion_coefficients", "mtx_left", "dist_left",
                        "mtx_right", "dist_right", "R", "T") if k in out]
    err = max(rel(out[k], ref[k]) for k in keys)
    check(err <= CALIB_TOL, f"{name}: card against CPU {err}")
    print(f"phase 14 {name}: {len(trace)} LM iterations ({sum(trace)} damped solves), "
          f"{ms / max(len(trace), 1):.2f} ms an iteration ({ms:.1f} ms), card against CPU "
          f"{err:.2e}; card {card}")
    return out


T0 = time.perf_counter()


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
                        ("census_words", "cost_volume", "aggregate_dual", "speckle_counts",
                         "sum_wta")),
        "full_lr_on": (SGMParams(num_disparities=D), flat,
                       ("census_words", "cost_volume", "aggregate_dual", "right_disparity",
                        "shift_gather", "speckle_counts", "sum_wta")),
        "production": (production_preset(), planes, tuple(KERNELS)),
    }
    pipes = {name: DepthPipeline(cal, p, min_depth=0.2, max_depth=4.0)
             for name, (p, _, _) in paths.items()}

    # -- 3. every kernel launch of one frame of each path against its plain version
    kernel_targets = [(sgm_cuda, name) for name in (*KERNELS, *NAMED_KERNELS)]
    stage_targets = [({"im": im, "sgm": sgm, "sgm_cuda": sgm_cuda}[m], n)
                     for m, names in STAGES.items() for n in names
                     if n not in NAMED_KERNELS]  # recorded as kernels already
    recorded = {}
    for name, (_, (left_np, right_np), _) in paths.items():
        targets = kernel_targets + (stage_targets if name in ("production", "full_lr_on") else [])
        with Recorder(torch, targets) as rec:
            pipes[name](left_np, right_np)
            torch.cuda.synchronize()
        recorded[name] = rec.calls
    errs = {k: max(parity(torch, sgm_cuda, {k: calls[k]}, path)
                   for path, calls in recorded.items()) for k in (*KERNELS, *NAMED_KERNELS)}
    # the full search's four volumes: one fused launch a frame, with the
    # summed volume only for the LR check
    for name, emit in (("full_lr_off", "none"), ("full_lr_on", "hwd")):
        fused = recorded[name]["sum_wta_fused"]
        check(len(fused) == 1 and fused[0][1].get("emit") == emit,
              f"{name}: sum_wta_fused calls {[kw for _, kw in fused]}, not one with emit {emit}")
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
        with Recorder(torch, [(sgm_cuda, "sum_wta")]) as plain_sum:
            sgm_cuda.reset_launch_counts()
            res = pipe(left_np, right_np)
            torch.cuda.synchronize()
            launches[name] = sgm_cuda.launch_counts()
        print(f"launches in one {name} frame: {launches[name]}")
        for k in must:
            check(launches[name][k] > 0, f"kernel {k} was not launched on the {name} path")
        check(launches[name]["median"] == MEDIAN_LAUNCHES[name],
              f"{name}: {launches[name]['median']} median launches, not "
              f"{MEDIAN_LAUNCHES[name]}")
        check(not plain_sum.calls["sum_wta"], f"the plain sum_wta ran on the {name} path")
        if name != "production":
            check(launches[name]["sum_wta"] == 1,
                  f"{name}: {launches[name]['sum_wta']} sum_wta launches, not 1")
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
        held = torch.cuda.memory_allocated()  # the recorded launches' inputs, among others
        pipe = pipes[name]
        for _ in range(WARMUP):
            pipe(left_np, right_np)
        torch.cuda.synchronize()
        frame_ms[name] = ms = cuda_ms(torch, lambda: pipe(left_np, right_np), FRAMES, warmup=0)
        peak = torch.cuda.max_memory_allocated()
        print(f"frame {name}: {ms:.3f} ms/frame, {1e3 / ms:.2f} frames/s ({W}x{H}, D={D}, "
              f"{FRAMES} timed frames after {WARMUP} warm-up; host-to-device copy of the pair "
              f"included), peak device memory {peak / 1e9:.2f} GB, of it the frame's own "
              f"{(peak - held) / 1e9:.2f} GB (above the {held / 1e9:.2f} GB this script holds), "
              f"card {card}")

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
            for a, kw in calls:  # one line per distinct shape (and axis), then the frame's total
                groups.setdefault(tuple(tuple(x.shape) for x in a if torch.is_tensor(x))
                                  + tuple(f"{k}={v}" for k, v in kw.items() if k == "axis"),
                                  []).append((a, kw))
            if len(groups) > 1:
                for shapes, g in groups.items():
                    g_ms = cuda_ms(torch, replay(fn, g), 20, warmup=3)
                    g_dev = device_ms(replay(fn, g), f"{kname} ({path}) at {shapes}")
                    nb = sum(work(kname, a, k)[0] for a, k in g)
                    ops = sum(work(kname, a, k)[1] for a, k in g)
                    b_ms, b_by = bound_ms(nb, ops)
                    print(f"kernel {kname} ({path}) at {shapes}: {g_ms:.4f} ms for {len(g)} "
                          f"launch(es), device alone {fmt(g_dev)}, bound {b_ms:.4f} ms ({b_by})")
            ms = cuda_ms(torch, replay(fn, calls), 20, warmup=3)
            dev = device_ms(replay(fn, calls), f"{kname} ({path})")
            plain_ms = cuda_ms(torch, replay(plain, calls), 2)
            nbytes = sum(work(kname, a, k)[0] for a, k in calls)
            ops = sum(work(kname, a, k)[1] for a, k in calls)
            b_ms, b_by = bound_ms(nbytes, ops)
            library_ms = library_dev = None
            if kname == "shift_gather":
                # torch.gather computes the same function where off ≤ x and
                # off < max_offset, which holds at every call of the path
                gathers = []
                for a, _ in calls:
                    srcv, off = a[0], a[1]
                    x = torch.arange(off.shape[-1], device=off.device)
                    idx = (x - off.long()).clamp(min=0).expand(srcv.shape).contiguous()
                    gathers.append((srcv, idx))

                def gather_all(gathers=gathers):
                    return [torch.gather(s_, -1, i_) for s_, i_ in gathers]

                library_ms = cuda_ms(torch, gather_all, 20, warmup=3)
                library_dev = device_ms(gather_all, f"torch.gather ({path})")
            print(f"kernel {kname} ({path}): {ms:.4f} ms per frame ({len(calls)} launches), device "
                  f"alone {fmt(dev)}, bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.1f} MB, "
                  f"{ops / 1e9:.2f} G operations), plain {plain_ms:.2f} ms"
                  + (f", torch.gather {library_ms:.4f} ms, device alone {fmt(library_dev)}"
                     if library_ms is not None else "")
                  + f", {100 * ms / frame_ms[path]:.1f}% of the frame")
            if path == "production":
                rows.append({
                    "name": kname, "route": "cuda", "source": f"{SOURCES}/{src}",
                    "replaces": f"{REPLACES}:{line}", "launches": launches["production"][kname],
                    "max_abs_err": errs[kname], "parity": "exact", "ms": ms, "device_ms": dev,
                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": library_ms, "library_device_ms": library_dev,
                    "design": DESIGNS.get(kname, FIRST_DESIGN),
                    "timed_as": "the production frame's launches, replayed on their inputs",
                })
            elif kname == "shift_gather":
                lr_full = {"ms": ms, "device_ms": dev, "library_ms": library_ms,
                           "library_device_ms": library_dev}
    check(len(rows) == len(KERNELS), "a kernel did not launch on the production path")
    next(r for r in rows if r["name"] == "shift_gather")["lr_on_full_launch"] = lr_full
    wname = "sum_wta_fused"
    kname, src, replaces = NAMED_KERNELS[wname]
    fn, plain = getattr(sgm_cuda, wname), plain_of(sgm_cuda, wname)
    timed = {}
    for path in ("full_lr_on", "full_lr_off"):
        calls = recorded[path][wname]
        ms = cuda_ms(torch, replay(fn, calls), 20, warmup=3)
        dev = device_ms(replay(fn, calls), f"{kname} ({path})")
        plain_ms = cuda_ms(torch, replay(plain, calls), 2)
        nbytes, ops = tally({wname: calls})
        b_ms, b_by = bound_ms(nbytes, ops)
        print(f"kernel {kname} ({path}): {ms:.4f} ms per frame ({len(calls)} launch, emit "
              f"{calls[0][1].get('emit')}), device alone {fmt(dev)}, bound {b_ms:.4f} ms "
              f"({b_by}; {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} G operations), plain "
              f"{plain_ms:.2f} ms, {100 * ms / frame_ms[path]:.1f}% of the frame")
        timed[path] = {"ms": ms, "device_ms": dev, "plain_ms": plain_ms, "bound_ms": b_ms,
                       "bound_by": b_by, "launches": launches[path][kname]}
    rows.append({
        "name": kname, "route": "cuda", "source": f"{SOURCES}/{src}", "replaces": replaces,
        **timed["full_lr_on"], "max_abs_err": errs[wname], "parity": "exact",
        "library_ms": None, "design": DESIGNS[kname],
        "timed_as": "the LR-on full search's launch (emit hwd), replayed on its inputs",
        "lr_off_full_launch": timed["full_lr_off"],
    })
    rows.append(median_row(torch, sgm_cuda, recorded, frame_ms, launches, errs))
    redesigned = {k: prod[k] for k in ("census_words", "cost_volume", "wta_stats_from_duals",
                                        "speckle_counts", "right_disparity",
                                        "nearest_valid_lohi")}
    redesigned["cost_volume"] = redesigned["cost_volume"] + [seeded_cost_launch(torch, sgm_cuda)]
    # the full search with the LR check: int16 at (720, 1280, 320)
    redesigned["right_disparity"] = (redesigned["right_disparity"]
                                     + recorded["full_lr_on"]["right_disparity"])
    # the full search's fused sum: its LR-on (hwd) and LR-off (none) launches
    # and seeded int16 volumes (a census with n_bits + P2 > 127) at its shape
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    redesigned["sum_wta_fused"] = (
        recorded["full_lr_on"]["sum_wta_fused"] + recorded["full_lr_off"]["sum_wta_fused"]
        + [(tuple(torch.randint(0, 150, (H, W, D), dtype=torch.int16, device="cuda",
                                generator=gen) for _ in range(4)), {"emit": "hwd"})])
    del recorded, prod
    torch.cuda.empty_cache()
    chain_rows, host = parallel_phases(torch, card)
    rows += chain_rows
    torch.cuda.empty_cache()
    script_rows, sum_script = script_phases(torch, card)
    rows += script_rows
    next(r for r in rows if r["name"] == "sum_wta")["script_device_ms"] = sum_script["sum_wta"]
    for kname, ab in redesign_phase(torch, card, redesigned).items():
        kname = NAMED_KERNELS.get(kname, (kname,))[0]
        next(r for r in rows if r["name"] == kname)["earlier_design_ab"] = ab
    del redesigned
    torch.cuda.empty_cache()
    next(r for r in rows if r["name"] == "shift_gather")["separable_remap"] = pipeline_phases(
        torch, card, cal, planes, launches["production"], frame_ms["production"])
    torch.cuda.empty_cache()
    fused = fused_phase(torch, card, cal, planes)
    torch.cuda.empty_cache()
    mono = mono_models_phase(torch, card, cal, planes)
    torch.cuda.empty_cache()
    calibrated, ba = calib_sfm_phase(torch, card)
    torch.cuda.empty_cache()
    served = serve_phase(torch, card, cal, planes)
    torch.cuda.empty_cache()
    train_phase(torch, card)
    torch.cuda.empty_cache()
    multihost_phase(torch, card, ba)
    torch.cuda.empty_cache()
    quality = quality_phase(torch, card)
    for r in rows:  # launches in one fused frame (its #7 in the gather warp), by network
        r["fused_launches"] = fused["launches"].get(r["name"], 0)
        r["mono_fused_launches"] = {arch: n.get(r["name"], 0) for arch, n in mono.items()}
        r["calibrated_frame_launches"] = calibrated.get(r["name"], 0)
        r["served_launches"] = {mode: n.get(r["name"], 0) for mode, n in served.items()}
        r["quality_boxes_launches"] = {mode: n.get(r["name"], 0) for mode, n in quality.items()}
    check(len(rows) == len(KERNELS) + len(NAMED_KERNELS) + len(SLICE3_KERNELS)
          + len(SLICE4_KERNELS), "a kernel row is missing")
    for r in rows:  # host µs of one launch through the wrapper, on a tiny input
        r["host_us"] = host["wrappers"].get(r["name"])
    next(r for r in rows if r["name"] == "shift_gather")["host_us_forms"] = host["shift_gather"]
    next(r for r in rows if r["name"] == "wta_stats_from_duals")["host_us_forms"] = host[
        "wta_stats_from_duals"]
    print(f"chip_smoke wall time: {time.perf_counter() - T0:.1f} s (phases 1-18, the build "
          f"included)")
    print(json.dumps({"kernels": rows}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multihost-rank"]:   # a child of phase 17
        sys.exit(multihost_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
