"""The stereo engine's CUDA graphs (``stereo.sgm.GRAPHS``, built on
``utils.graphs``).

On the CPU: the cache's keys, counts and bound with a stand-in capture, and
the engine's CPU calls, which never capture and give the maps of the eager
engine. The ``cuda`` tests (skipped without a card) run seeded frames
through the public calls on the card, eager, captured and replayed, each
bit for bit against the eager engine, and count each way's launches:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_graphs.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from stereovision_tpu_torch.ops import sgm_cuda
from stereovision_tpu_torch.stereo import SGMParams, production_preset, sgm
from stereovision_tpu_torch.utils import graphs


def pair(h, w, shift, seed):
    """A textured pair, the right image the left shifted by ``shift`` px."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h, w + shift + 4)).astype(np.float32)
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3.0
    return np.ascontiguousarray(base[:, shift:shift + w]), np.ascontiguousarray(base[:, :w])


def fused_params(num_disparities=96):
    """``FusedPipeline``'s engine settings (its D at scale 0.33 is 96)."""
    return SGMParams(num_disparities=num_disparities, mode="hier", coarse_scale=2,
                     refine_range=32, paths=2)


# ---------------------------------------------------------------------------
# The cache, with a stand-in capture
# ---------------------------------------------------------------------------


class StandIn:
    """A capture that runs ``fn`` and returns a replay that runs it again,
    logging each capture, each replay and each replay freed."""

    def __init__(self):
        self.log = []

    def __call__(self, fn, inputs):
        self.log.append(("capture", inputs))
        log = self.log

        class Replay:
            def __call__(self, *args):
                log.append(("replay", args))
                return fn(*args)

            def __del__(self):
                log.append(("freed", inputs))

        return Replay(), fn(*inputs)


def test_a_key_runs_eagerly_then_is_captured_then_replayed():
    cap = StandIn()
    cache = graphs.GraphCache(cap, size=2)
    outs = [cache("k", lambda x: x * 2, x) for x in range(5)]
    assert outs == [0, 2, 4, 6, 8]
    assert cache.counts == {"eager": 1, "captures": 1, "replays": 3}
    assert [e[0] for e in cap.log] == ["capture", "replay", "replay", "replay"]
    assert cap.log[0][1] == (1,)  # the second call is the one captured


def test_calls_keyed_none_and_a_cache_of_size_0_never_capture():
    cap = StandIn()
    cache = graphs.GraphCache(cap, size=0)
    for x in range(3):
        assert cache(None, lambda v: v + 1, x) == x + 1
        assert cache("k", lambda v: v + 1, x) == x + 1
    assert cache.counts == {"eager": 6, "captures": 0, "replays": 0}
    assert cap.log == []


def test_the_least_recently_used_graph_goes_first_and_is_freed():
    cap = StandIn()
    cache = graphs.GraphCache(cap, size=2)
    for key in ("a", "b", "a", "b"):
        cache(key, lambda v: v, 0)
    cache("a", lambda v: v, 0)  # a replay: "b" is now the least recently used
    for _ in range(2):
        cache("c", lambda v: v, 0)  # eager, then captured in "b"'s place
    assert ("freed", (0,)) in cap.log and len(cache._graphs) == 2
    assert list(cache._graphs) == ["a", "c"]
    before = dict(cache.counts)
    cache("b", lambda v: v, 0)  # forgotten with its graph: eager again
    assert cache.counts["eager"] == before["eager"] + 1


def test_resize_frees_graphs_and_reset_forgets_keys_and_counts():
    cap = StandIn()
    cache = graphs.GraphCache(cap, size=3)
    for key in ("a", "a", "b", "b", "c", "c"):
        cache(key, lambda v: v, 1)
    cache.resize(1)
    assert list(cache._graphs) == ["c"] and cache.size == 1
    assert sum(1 for e in cap.log if e[0] == "freed") == 2
    cache.resize(0)
    assert cache("c", lambda v: v, 1) == 1 and cache.counts["replays"] == 0
    cache.resize(3)
    cache("d", lambda v: v, 1)
    cache.reset()
    assert cache.counts == {"eager": 0, "captures": 0, "replays": 0}
    cache("d", lambda v: v, 1)
    assert cache.counts["eager"] == 1 and not cache._graphs


def test_keys_seen_once_are_bounded():
    cache = graphs.GraphCache(StandIn(), size=1)
    for key in range(40):
        cache(key, lambda v: v, 0)
    assert len(cache._seen) == 16
    cache(39, lambda v: v, 0)  # still remembered: captured
    cache(0, lambda v: v, 0)   # forgotten: eager again
    assert cache.counts == {"eager": 41, "captures": 1, "replays": 0}


# ---------------------------------------------------------------------------
# The engine's CPU calls
# ---------------------------------------------------------------------------

CPU_CASES = {
    "production": (dataclasses.replace(production_preset(), num_disparities=64), 48, 192, 21),
    "full": (SGMParams(num_disparities=32), 40, 72, 5),
    "fused": (fused_params(32), 48, 128, 11),
}


@pytest.mark.parametrize("case", sorted(CPU_CASES))
def test_cpu_calls_never_capture_and_give_the_eager_maps(case):
    p, h, w, shift = CPU_CASES[case]
    sgm.GRAPHS.reset()
    launched = sgm_cuda.launch_counts()
    for seed in range(3):
        left, right = pair(h, w, shift, seed)
        disp, conf = sgm.disparity_with_confidence(left, right, p, device="cpu")
        d2, valid = sgm.compute_disparity(left, right, p, device="cpu")
        want, want_valid = sgm._compute_disparity(torch.from_numpy(left), torch.from_numpy(right),
                                                  p)
        assert torch.equal(disp, want) and torch.equal(d2, want)
        assert torch.equal(valid, want_valid)
        lo, hi = p.min_disparity + 1, p.min_disparity + p.num_disparities - 1
        assert torch.equal(conf, (want_valid & (want > lo) & (want < hi)).float())
    assert sgm.graph_counts() == {"eager": 6, "captures": 0, "replays": 0}
    assert sgm_cuda.launch_counts() == launched


def calibration(w, h, f=700.0, tx=-6.0):
    """An identity-rectified rig: focal length f px, baseline tx cm along x."""
    K = np.array([[f, 0, (w - 1) / 2], [0, f, (h - 1) / 2], [0, 0, 1]])
    P1 = np.hstack([K, np.zeros((3, 1))])
    P2 = P1.copy()
    P2[0, 3] = tx * f
    return {"mtx_left": K, "mtx_right": K, "dist_left": np.zeros(5),
            "dist_right": np.zeros(5), "R": np.eye(3), "T": np.array([[tx], [0.0], [0.0]]),
            "R1": np.eye(3), "R2": np.eye(3), "P1": P1, "P2": P2,
            "img_size": np.array([w, h])}


def test_cpu_pipeline_frames_run_eagerly():
    from stereovision_tpu_torch.pipeline import DepthPipeline

    h, w = 48, 192
    p = dataclasses.replace(production_preset(), num_disparities=64)
    pipe = DepthPipeline(calibration(w, h), p, device="cpu")
    sgm.GRAPHS.reset()
    left, right = pair(h, w, 21, 7)
    res = [pipe(left, right) for _ in range(3)]
    assert sgm.graph_counts() == {"eager": 3, "captures": 0, "replays": 0}
    assert all(torch.equal(r.disparity, res[0].disparity) for r in res)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


# (settings, height, width, shift): each at 720p or its own processing
# size, and small
CARD_CASES = {
    "production-720p": (production_preset(), 720, 1280, 40),
    "production-small": (dataclasses.replace(production_preset(), num_disparities=64), 48, 192,
                         21),
    "full-720p": (SGMParams(num_disparities=320), 720, 1280, 40),
    "full-small": (SGMParams(num_disparities=32), 40, 72, 5),
    "fused-236x422": (fused_params(), 236, 422, 20),
    "fused-small": (fused_params(32), 48, 128, 11),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_graphed_frames_equal_the_eager_engine_bit_for_bit(cuda, case):
    """Five seeded frames through ``disparity_with_confidence``: the first
    eager, the second captured, three replayed; each frame's maps equal the
    eager engine's on the same pair bit for bit, the first frame's outputs
    survive the later frames, and a captured or replayed frame counts the
    launches of an eager one."""
    p, h, w, shift = CARD_CASES[case]
    frames = [tuple(torch.from_numpy(x).to(cuda) for x in pair(h, w, shift + k, 100 + k))
              for k in range(5)]
    sgm.GRAPHS.reset()
    got, launches = [], []
    for left, right in frames:
        sgm_cuda.reset_launch_counts()
        got.append(sgm.disparity_with_confidence(left, right, p, device=cuda))
        torch.cuda.synchronize()
        launches.append({k: n for k, n in sgm_cuda.launch_counts().items() if n})
    first = tuple(t.clone() for t in got[0])
    assert sgm.graph_counts() == {"eager": 1, "captures": 1, "replays": 3}
    assert launches[0] and all(n == launches[0] for n in launches[1:]), launches
    for (left, right), maps in zip(frames, got):
        want = sgm._disparity_and_confidence(left, right, p)
        for a, b in zip(maps, want):
            assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(first, got[0]))
    assert not torch.equal(got[0][0], got[1][0])  # distinct frames, distinct maps
    # compute_disparity is keyed apart and gives the same disparity
    sgm.GRAPHS.reset()
    for left, right in frames[:3]:
        disp, valid = sgm.compute_disparity(left, right, p, device=cuda)
    want, want_valid = sgm._compute_disparity(*frames[2], p)
    assert torch.equal(_bits(disp), _bits(want)) and torch.equal(valid, want_valid)
    assert sgm.graph_counts() == {"eager": 1, "captures": 1, "replays": 1}


@pytest.mark.cuda
def test_a_new_setting_captures_anew_and_the_oldest_graph_is_freed(cuda):
    """Each setting is captured on its own second call; past the bound the
    least recently used graph goes, and its memory pool with it."""
    sgm.GRAPHS.reset()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved(cuda)
    big = tuple(torch.from_numpy(x).to(cuda) for x in pair(720, 1280, 40, 1))
    full = SGMParams(num_disparities=320)
    for _ in range(3):
        sgm.disparity_with_confidence(*big, full, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved(cuda)
    assert held > base + 1e9  # the full search's graph holds its volumes
    small = tuple(torch.from_numpy(x).to(cuda) for x in pair(40, 72, 5, 2))
    settings = [SGMParams(num_disparities=32, p2=96.0 + k) for k in range(sgm.GRAPHS.size)]
    for p in settings:
        for _ in range(2):
            sgm.disparity_with_confidence(*small, p, device=cuda)
    assert sgm.graph_counts() == {"eager": 1 + len(settings), "captures": 1 + len(settings),
                                  "replays": 1}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved(cuda) < held - 1e9
    sgm.disparity_with_confidence(*small, settings[-1], device=cuda)
    assert sgm.graph_counts()["replays"] == 2
    sgm.disparity_with_confidence(*big, full, device=cuda)  # forgotten: eager again
    assert sgm.graph_counts()["eager"] == 2 + len(settings)
    sgm.GRAPHS.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("change", [
    {"mode": "hier2", "num_disparities": 64, "refine_range": 32, "paths": 2, "coarse_scale": 3,
     "coarse_paths": 4, "fill_invalid": True},
    {"mode": "hier", "num_disparities": 64, "coarse_scale": 2},
    {"num_disparities": 32, "fill_invalid": True, "min_disparity": 4},
    {"num_disparities": 32, "lr_max_diff": -1, "speckle_window_size": 0, "median_ksize": 1},
    {"num_disparities": 32, "paths": 2, "stats_impl": "xla", "uniqueness_ratio": 0},
    {"num_disparities": 32, "pack": 2, "lr_groups": 1},
    {"num_disparities": 32, "paths": 2, "agg_wseg": 2, "subpixel": False},
    {"num_disparities": 32, "impl": "xla"},
])
def test_other_settings_replay_the_eager_maps(cuda, change):
    """Settings the cells do not run capture and replay too, bit for bit."""
    p = dataclasses.replace(SGMParams(), **change)
    frames = [tuple(torch.from_numpy(x).to(cuda) for x in pair(48, 256, 9 + k, 200 + k))
              for k in range(3)]
    sgm.GRAPHS.reset()
    got = [sgm.compute_disparity(left, right, p, device=cuda) for left, right in frames]
    assert sgm.graph_counts() == {"eager": 1, "captures": 1, "replays": 1}
    for (left, right), maps in zip(frames, got):
        want = sgm._compute_disparity(left, right, p)
        assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(maps, want))
