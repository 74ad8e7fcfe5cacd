"""Leveled logging and per-stage wall-clock statistics.

Counterpart of ``stereovision_tpu/utils/logging.py``: ``get_logger`` and
``StageTimer``, which averages each stage's wall time and reports every
``report_every`` frames (the original tool's per-30-frame stats block).
"""

from __future__ import annotations

import json
import logging
import time


def get_logger(name: str = "stereovision_tpu_torch", level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
        logger.setLevel(level)
    return logger


class StageTimer:
    """Accumulates wall-clock per stage; reports every ``report_every``
    frames. A stage timed around a call that only queues work on a card
    measures the queuing, not the card."""

    def __init__(self, report_every: int = 30, logger: logging.Logger | None = None):
        self.report_every = report_every
        self.logger = logger or get_logger()
        self._acc: dict[str, list[float]] = {}
        self._frame_t: list[float] = []
        self._n = 0
        self._last_report: dict | None = None

    class _Ctx:
        def __init__(self, timer, stage):
            self.timer, self.stage = timer, stage

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.timer._acc.setdefault(self.stage, []).append(time.perf_counter() - self.t0)

    def stage(self, name: str) -> "StageTimer._Ctx":
        return self._Ctx(self, name)

    def frame_done(self, frame_seconds: float | None = None):
        if frame_seconds is not None:
            self._frame_t.append(frame_seconds)
        self._n += 1
        if self._n % self.report_every == 0:
            self._last_report = self.report()
            self.logger.info("perf %s", json.dumps(self._last_report))
            self._acc.clear()
            self._frame_t.clear()

    def report(self) -> dict:
        out = {k: round(1000 * sum(v) / max(len(v), 1), 2) for k, v in self._acc.items()}
        if self._frame_t:
            mean_f = sum(self._frame_t) / len(self._frame_t)
            out["fps"] = round(1.0 / mean_f, 2) if mean_f > 0 else None
        out["frames"] = self._n
        return out
