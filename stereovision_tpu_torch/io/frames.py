"""Frame sources: the offline/streaming replacement for the reference's webcam
layer (SURVEY L3 — there are no webcams on a TPU pod).

``PairedImageSource`` reproduces the reference's left/right pairing semantics:
files matching ``left_*.<ext>`` whose ``right_`` twin exists, sorted
(stereo_calibration.py:100-107, capture naming 2camers.py:1697-1723).

The port's own copy of ``stereovision_tpu/io/frames.py``: numpy on the
host, ``imageio``/``cv2`` imported where a frame is read. Grayscale pairs
of JPEG, PNG and PNM files decode through the native threaded loader
(``io.native_loader``) where it builds, as in the reference; other
files, colour frames, or a machine without the loader read through
``imageio``. A file the native loader cannot decode raises.

:func:`imread_gray` reads one frame: binary 8-bit netpbm (``P5`` PGM,
``P6`` PPM) through its own numpy decoder (:func:`read_netpbm`), JPEG and
PNG through the native loader where it builds, anything else through
``imageio``; where none of them can read the file it raises an
``ImportError`` naming what is missing.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np


# what native/loader.cpp decodes
_NATIVE_SUFFIXES = (".jpg", ".jpeg", ".png", ".ppm", ".pgm")


def _to_gray(img: np.ndarray) -> np.ndarray:
    """RGB (or already-gray) frame → BT.601 luma float32."""
    if img.ndim == 3:
        img = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    return np.asarray(img, np.float32)


def _to_bgr(img: np.ndarray) -> np.ndarray:
    """RGB (or gray) frame → (H, W, 3) BGR float32."""
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img[..., :3][..., ::-1].astype(np.float32)


def _imread_gray(path: Path) -> np.ndarray:
    import imageio.v2 as iio

    return _to_gray(np.asarray(iio.imread(path)))


def _imread_bgr(path: Path) -> np.ndarray:
    import imageio.v2 as iio

    return _to_bgr(np.asarray(iio.imread(path)))


_NETPBM_SUFFIXES = (".pgm", ".ppm", ".pnm")


def _netpbm_header(data: bytes, path) -> tuple[bytes, list[int], int]:
    """(magic, [width, height, maxval], the raster's offset) of a binary
    netpbm file; ``#`` comments may sit between the fields."""
    fields, pos = [], 2
    while len(fields) < 3:
        while pos < len(data) and (data[pos:pos + 1].isspace() or data[pos:pos + 1] == b"#"):
            if data[pos:pos + 1] == b"#":
                end = data.find(b"\n", pos)
                pos = len(data) if end < 0 else end
            pos += 1
        start = pos
        while pos < len(data) and data[pos:pos + 1].isdigit():
            pos += 1
        if pos == start or pos >= len(data) or not data[pos:pos + 1].isspace():
            raise ValueError(f"{path}: malformed netpbm header (field {len(fields) + 1} of "
                             "width, height, maxval)")
        fields.append(int(data[start:pos]))
    return data[:2], fields, pos + 1  # one whitespace byte ends the header


def read_netpbm(path) -> np.ndarray:
    """A binary 8-bit netpbm file → uint8 (H, W) for ``P5`` or (H, W, 3)
    for ``P6``: the array ``imageio`` decodes from the same file. Any other
    magic, a maxval above 255 (16-bit samples), a zero size or a short
    raster raises ``ValueError``."""
    data = Path(path).read_bytes()
    magic = data[:2]
    if magic not in (b"P5", b"P6") or len(data) < 3 or not data[2:3].isspace():
        raise ValueError(f"{path}: not a binary PGM/PPM (magic {magic!r}; P5 or P6 decoded)")
    _, (w, h, maxval), start = _netpbm_header(data, path)
    if not 0 < maxval < 256:
        raise ValueError(f"{path}: maxval {maxval}: only 8-bit netpbm samples are decoded")
    if w == 0 or h == 0:
        raise ValueError(f"{path}: empty netpbm image ({w}x{h})")
    ch = 1 if magic == b"P5" else 3
    n = w * h * ch
    if len(data) - start < n:
        raise ValueError(f"{path}: netpbm raster holds {len(data) - start} bytes, not {n}")
    img = np.frombuffer(data, np.uint8, count=n, offset=start)
    return img.reshape((h, w) if ch == 1 else (h, w, 3)).copy()


def imread_gray(path) -> np.ndarray:
    """Public single-image grayscale loader (float32 (H, W)): binary 8-bit
    PGM/PPM through :func:`read_netpbm`, JPEG and PNG through the native
    loader where it builds (a file it cannot decode raises), anything else
    through ``imageio``."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix in _NETPBM_SUFFIXES:
        with open(path, "rb") as f:
            if f.read(2) in (b"P5", b"P6"):
                return _to_gray(read_netpbm(path))
    if suffix in (".jpg", ".jpeg", ".png"):
        from stereovision_tpu_torch.io import native_loader

        if native_loader.available():
            return native_loader.decode(path, gray=True)
    import importlib.util

    if importlib.util.find_spec("imageio") is None:
        raise ImportError(
            f"reading {path.name} needs imageio, which is not installed here (binary PGM/PPM "
            "decode without it, and JPEG/PNG where the native loader builds)")
    return _imread_gray(path)


@dataclasses.dataclass
class PairedImageSource:
    """Iterates (left, right) grayscale float32 frames from a directory."""

    directory: str | Path
    left_prefix: str = "left_"
    right_prefix: str = "right_"
    color: bool = False

    def pairs(self):
        d = Path(self.directory)
        lefts = sorted(
            p for p in d.iterdir()
            if p.name.startswith(self.left_prefix)
            and p.suffix.lower() in (".jpg", ".jpeg", ".png", ".bmp", ".ppm", ".pgm")
        )
        out = []
        for lp in lefts:
            rp = lp.with_name(self.right_prefix + lp.name[len(self.left_prefix):])
            if rp.exists():
                out.append((lp, rp))
        return out

    def __len__(self):
        return len(self.pairs())

    def __iter__(self):
        pairs = self.pairs()
        flat = [p for pair in pairs for p in pair]
        if (not self.color and flat
                and all(p.suffix.lower() in _NATIVE_SUFFIXES for p in flat)):
            from stereovision_tpu_torch.io import native_loader

            if native_loader.available():
                # the native threaded decoder prefetches ahead of the
                # consumer (left/right interleaved in one window)
                with native_loader.PrefetchingLoader(flat, gray=True) as ld:
                    for i in range(len(pairs)):
                        yield ld.fetch(2 * i), ld.fetch(2 * i + 1)
                return
        read = _imread_bgr if self.color else _imread_gray
        for lp, rp in pairs:
            yield read(lp), read(rp)


@dataclasses.dataclass
class VideoSource:
    """Frames from a video file: imageio's ffmpeg plugin when present, else
    cv2.VideoCapture (whose bundled codecs cover MJPG/AVI and more). Raises a
    clear error only when neither backend can decode the file."""

    path: str | Path
    color: bool = False
    step: int = 1

    def __iter__(self):
        if self.step < 1:
            raise ValueError(f"step must be >= 1, got {self.step}")
        try:
            import imageio.v2 as iio

            reader = iio.get_reader(str(self.path))
        except Exception as iio_err:
            yield from self._iter_cv2(iio_err)
            return
        try:
            for i, frame in enumerate(reader):
                if i % self.step:
                    continue
                f = np.asarray(frame)
                yield _to_bgr(f) if self.color else _to_gray(f)
        finally:
            reader.close()  # don't leak the ffmpeg subprocess on early exit

    def _iter_cv2(self, iio_err):
        try:
            import cv2

            cap = cv2.VideoCapture(str(self.path))
            opened = cap.isOpened()
        except Exception:
            cap, opened = None, False
        if not opened:
            if cap is not None:
                cap.release()
            raise RuntimeError(
                f"video decoding unavailable for {self.path} (imageio: "
                f"{iio_err}; cv2.VideoCapture could not open it); extract "
                "frames to images and use PairedImageSource"
            ) from iio_err
        try:
            i = 0
            got_any = False
            while True:
                ok, frame = cap.read()  # BGR
                if not ok:
                    break
                got_any = True
                if i % self.step == 0:
                    if self.color:
                        yield frame.astype(np.float32)  # already BGR
                    else:
                        yield _to_gray(frame[:, :, ::-1])
                i += 1
            if not got_any:
                raise RuntimeError(
                    f"video decoding unavailable for {self.path} (imageio: "
                    f"{iio_err}; cv2 opened it but decoded no frames); "
                    "extract frames to images and use PairedImageSource"
                )
        finally:
            cap.release()


@dataclasses.dataclass
class SyntheticStereoSource:
    """Procedural rectified stereo pairs with known disparity (tests/demos).

    Scene: textured background at disparity ``d_far`` with a textured square
    object at ``d_near``.
    """

    height: int = 240
    width: int = 320
    n_frames: int = 10
    d_near: float = 24.0
    d_far: float = 6.0
    seed: int = 0

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        H, W = self.height, self.width
        pad = int(self.d_near) + 8
        for k in range(self.n_frames):
            base = rng.uniform(0, 255, size=(H, W + pad)).astype(np.float32)
            # smooth for matchable texture
            kern = np.ones(3) / 3
            base = np.apply_along_axis(lambda r: np.convolve(r, kern, "same"), 1, base)
            left = base[:, : W].copy()
            right = base[:, int(self.d_far) : int(self.d_far) + W].copy()
            # near object: a square shifted by d_near instead of d_far
            y0, x0 = H // 4 + 2 * k, W // 3 + 2 * k
            y1, x1 = y0 + H // 4, x0 + W // 4
            obj = rng.uniform(0, 255, size=(y1 - y0, x1 - x0)).astype(np.float32)
            left[y0:y1, x0:x1] = obj
            rx0 = x0 - int(self.d_near)
            right[y0:y1, rx0 : rx0 + (x1 - x0)] = obj
            truth = np.full((H, W), self.d_far, np.float32)
            truth[y0:y1, x0:x1] = self.d_near
            yield left, right, truth
