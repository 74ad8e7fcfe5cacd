"""The stereo pipeline's upload (``DepthPipeline._upload`` on
``utils.backend.upload``): an image in host memory goes to the card in its
own dtype through pinned memory of the program's, without a host wait, and
is cast to float32 there.

On the CPU: the card path hands ``upload`` the image as it came; the CPU
path casts where the image is, and host inputs of every
kind give the maps of their float32 image. The ``cuda`` tests (skipped
without a card) run 720p calls of production and the full search: every
kind of host input gives, bit for bit, the maps of the same call on the
image cast on the host and already on the card; the caller may overwrite
its array or pinned tensor right after the call; and three frames in flight
each give the maps of their own frame run alone. Those two hold the card
with a spin kernel for ten times the host's time of the calls they make, and
at least 200 ms, so that a call that waited for the card is seen:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_upload.py
"""

import time

import numpy as np
import pytest
import torch

from stereovision_tpu_torch import pipeline
from stereovision_tpu_torch.stereo import SGMParams, production_preset
from stereovision_tpu_torch.utils.backend import upload


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


def pair(h, w, shift, seed):
    """Smoothed uint8 noise and the same seen ``shift`` px to the left."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h, w + shift + 1))
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3.0
    base = base.round().astype(np.uint8)
    return np.ascontiguousarray(base[:, shift:shift + w]), np.ascontiguousarray(base[:, :w])


def host_inputs(kind, h, w, seed):
    """(host pair of ``kind``, the same images as float32 arrays cast on the
    host): the images of a frame as a caller may hand them over."""
    left, right = pair(h, w, 24, seed)
    if kind == "uint8":
        return (left, right), (left, right)
    if kind == "reversed":  # views with a negative stride
        views = tuple(np.ascontiguousarray(x[:, ::-1])[:, ::-1] for x in (left, right))
        assert views[0].strides[1] < 0
        return views, (left, right)
    if kind == "float32":
        frac = np.random.default_rng(seed + 1).random((2, h, w), dtype=np.float32)
        imgs = tuple(x + f for x, f in zip((left, right), frac))
        return imgs, imgs
    if kind == "float64":  # fractions that float32 has to round
        frac = np.random.default_rng(seed + 1).random((2, h, w)) / 3.0
        imgs = tuple(x + f for x, f in zip((left, right), frac))
        return imgs, imgs
    if kind == "pinned":
        return tuple(torch.from_numpy(x).pin_memory() for x in (left, right)), (left, right)
    if kind == "resized":  # another size than the pipeline's: the resize branch
        small = pair(h // 2, w // 2, 12, seed)
        return small, small
    raise ValueError(kind)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_same_maps(got, want):
    for name in ("disparity", "confidence", "depth_m"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b)), name


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------


def test_the_card_path_hands_upload_the_image_as_it_came(monkeypatch):
    """On a card ``_upload`` sends the image in its own dtype through
    ``upload`` and casts what comes back to float32."""
    pipe = pipeline.DepthPipeline(calibration(64, 32), SGMParams(num_disparities=16),
                                  device="cpu")
    seen = []

    def fake_upload(x, device):
        seen.append((x, device))
        return torch.from_numpy(np.ascontiguousarray(x))

    monkeypatch.setattr(pipeline, "upload", fake_upload)
    pipe.device = torch.device("cuda")
    img = pair(32, 64, 4, 1)[0]
    out = pipe._upload(img)
    assert len(seen) == 1 and seen[0][0] is img and seen[0][1] == torch.device("cuda")
    assert out.dtype == torch.float32 and torch.equal(out, torch.from_numpy(img).float())


def test_upload_on_the_cpu_keeps_the_dtype_and_makes_views_contiguous():
    cpu = torch.device("cpu")
    img = pair(16, 32, 2, 2)[0]
    t = upload(img[:, ::-1], cpu)
    assert t.dtype == torch.uint8 and t.is_contiguous()
    assert np.array_equal(t.numpy(), img[:, ::-1])
    s = torch.from_numpy(img)
    assert upload(s, cpu) is s


@pytest.mark.parametrize("kind", ["uint8", "float32", "float64", "resized"])
def test_cpu_host_inputs_give_the_maps_of_their_float32_images(kind):
    """The CPU path casts where the image is (``torch.as_tensor``, which
    takes no negative strides): every kind of host input it takes gives the
    maps of its float32 image."""
    h, w = 48, 128
    pipe = pipeline.DepthPipeline(calibration(w, h), SGMParams(num_disparities=32),
                                  device="cpu")
    imgs, ref = host_inputs(kind, h, w, 3)
    want = pipe(*(torch.from_numpy(np.asarray(x, np.float32)) for x in ref))
    assert_same_maps(pipe(*imgs), want)
    if kind == "uint8":
        assert_same_maps(pipe(*(torch.from_numpy(x) for x in imgs)), want)


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

H, W = 720, 1280
KINDS = ["uint8", "reversed", "float32", "float64", "pinned", "resized"]


@pytest.fixture(scope="module")
def card_pipes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    params = {"production": production_preset(), "full": SGMParams(num_disparities=320)}
    pipes = {mode: pipeline.DepthPipeline(calibration(W, H), p, device="cuda")
             for mode, p in params.items()}
    warm = on_card(pair(H, W, 24, 0))
    for pipe in pipes.values():  # eager, captured, replayed: the tests' calls replay
        for _ in range(3):
            pipe(*warm)
    torch.cuda.synchronize()
    return pipes


def on_card(imgs):
    """The images cast to float32 on the host and copied to the card."""
    return tuple(torch.from_numpy(np.asarray(x, np.float32)).cuda() for x in imgs)


def run_alone(pipe, imgs):
    """The maps of one call on ``imgs`` with nothing else in flight."""
    torch.cuda.synchronize()
    out = pipe(*imgs)
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", ["production", "full"])
def test_host_inputs_give_the_maps_of_the_image_on_the_card(card_pipes, mode, kind):
    pipe = card_pipes[mode]
    imgs, ref = host_inputs(kind, H, W, 10)
    want = run_alone(pipe, on_card(ref))
    got = pipe(*imgs)
    torch.cuda.synchronize()
    assert_same_maps(got, want)


def host_ms(pipe, frames) -> float:
    """The host's ms for calls on ``frames`` back to back, nothing in flight
    before them: the longest of three tries."""
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in frames:
            pipe(*f)
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return max(times)


def hold_the_card(ms: float) -> torch.cuda.Event:
    """Keep the card's stream busy for at least ``ms`` (a spin kernel whose
    cycles a ms are timed first); returns the event of the hold's end,
    which a host that waited for the card finds done."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(10_000_000)
    stop.record()
    stop.synchronize()
    torch.cuda._sleep(int(10_000_000 / start.elapsed_time(stop) * ms))
    end = torch.cuda.Event()
    end.record()
    return end


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["production", "full"])
def test_the_caller_may_overwrite_its_buffers_right_after_the_call(card_pipes, mode):
    """Behind work still running, a call on the caller's numpy array and
    pinned tensor returns before their copies run; the caller overwrites
    both at once, and the call's maps are still those of the frame it was
    given."""
    pipe = card_pipes[mode]
    first, second = pair(H, W, 24, 20), pair(H, W, 30, 21)
    want = run_alone(pipe, on_card(second))
    left = second[0].copy()
    right = torch.from_numpy(second[1]).pin_memory()
    held = hold_the_card(max(200.0, 10 * host_ms(pipe, [first])))
    got = pipe(left, right)
    left[:] = first[0]
    right.copy_(torch.from_numpy(first[1]))
    assert not held.query()  # the call waited for nothing
    torch.cuda.synchronize()
    assert_same_maps(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["production", "full"])
def test_three_frames_in_flight_each_give_their_own_maps(card_pipes, mode):
    """Three calls on three frames back to back, none waited for: each
    gives the maps of its own frame run alone."""
    pipe = card_pipes[mode]
    frames = [pair(H, W, 20 + 5 * k, 30 + k) for k in range(3)]
    want = [run_alone(pipe, on_card(f)) for f in frames]
    held = hold_the_card(max(200.0, 10 * host_ms(pipe, frames)))
    got = [pipe(*f) for f in frames]
    assert not held.query()  # all three in flight at once
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert_same_maps(g, w)
