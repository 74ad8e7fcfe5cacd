"""Finding a cell's parts by name: the spec (``BENCHMARK.json``), the
configuration (``configs/<name>.json``), the traffic mix
(``traffic/<name>.json``), the comparison's limits (``limits/<config>.json``),
each metric's reader (``metrics/<name>.py``, else
``metrics/<name up to its first dot>.py``: ``call_host_ms.live`` and
``call_host_ms.replay`` share ``call_host_ms.py``), and the modules that
the configuration and the mix name: the system under test
(``systems/<config's system>.py``), the plain reference with its comparison
(``references/<config's reference>.py``), the generator of inputs
(``generators/<mix's generator>.py``) and the loop of the window
(``loops/<mix's loop>.py``).

A new cell, configuration, mix, loop, generator, system, reference or
metric is a new file and a new entry of the spec; nothing here changes for
it.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent


class Catalog:
    """The benchmark's files under ``root`` (the folder of this module by
    default) and the spec at ``spec_path`` (``BENCHMARK.json`` beside
    ``root``)."""

    def __init__(self, root: Path | str = ROOT, spec_path: Path | str | None = None):
        self.root = Path(root)
        self.spec_path = Path(spec_path) if spec_path else self.root.parent / "BENCHMARK.json"
        self.spec = json.loads(self.spec_path.read_text())
        self._modules: dict[tuple[str, str], object] = {}

    def _json(self, folder: str, name: str) -> dict:
        path = self.root / folder / f"{name}.json"
        if not path.is_file():
            raise KeyError(f"no {folder[:-1] if folder.endswith('s') else folder} named {name!r}"
                           f" ({path} is missing)")
        return json.loads(path.read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in {self.spec_path}")

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, config: str) -> dict:
        return self._json("limits", config)

    def metrics(self, cell: str, traced: bool) -> list[dict]:
        """The spec's metrics that a run of ``cell`` reports: the
        end-to-end ones untraced, the per-layer ones traced; a metric with
        a ``workloads`` list only in the cells it names."""
        group = self.spec["per_layer" if traced else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def module(self, folder: str, name: str):
        """The module ``<folder>/<name>.py``, loaded from its file."""
        path = self.root / folder / f"{name}.py"
        if not path.is_file():
            raise KeyError(f"no module {name!r} under {self.root / folder}")
        key = (folder, name)
        if key not in self._modules:
            spec = importlib.util.spec_from_file_location(
                f"benchmark_{folder}_{name.replace('.', '_')}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            self._modules[key] = module
        return self._modules[key]

    def reader(self, metric: str):
        """The ``read(ctx)`` function of a metric's reader file."""
        for stem in (metric, metric.split(".", 1)[0]):
            if (self.root / "metrics" / f"{stem}.py").is_file():
                return self.module("metrics", stem).read
        raise KeyError(f"no reader for metric {metric!r} under {self.root / 'metrics'}")
