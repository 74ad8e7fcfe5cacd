"""The import checks: top-level names compared whole, and the yardstick
importing nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmark.importcheck import FORBIDDEN, forbidden_loaded

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
# the yardstick: what decides correct and what the metrics count
YARDSTICK = ("references/depth_maps.py", "compare.py", "work.py", "generators/scene.py",
             "depth_config.py", "stats.py", "timeline.py", "references/fused_frame.py",
             "fused_work.py", "generators/scene_pingpong.py")


def test_names_are_compared_whole():
    modules = {"jax": 1, "jax.numpy": 1, "jaxlib.xla_client": 1, "flax.linen": 1,
               "stereovision_tpu": 1, "stereovision_tpu.stereo.sgm": 1,
               "stereovision_tpu_torch": 1, "stereovision_tpu_torch.pipeline": 1,
               "jaxtyping": 1, "flaxen": 1, "numpy": 1}
    assert forbidden_loaded(modules) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "stereovision_tpu",
         "stereovision_tpu.stereo.sgm"])
    assert FORBIDDEN == {"jax", "jaxlib", "flax", "stereovision_tpu"}


def imported(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_no_source_of_the_benchmark_imports_jax():
    for path in BENCH.rglob("*.py"):
        for name in imported(path):
            assert name.split(".", 1)[0] not in FORBIDDEN, (path, name)


def test_the_yardstick_imports_nothing_of_the_program():
    for name in YARDSTICK:
        for mod in imported(BENCH / name):
            assert not mod.split(".", 1)[0].startswith("stereovision"), (name, mod)
    code = ("import sys; sys.path.insert(0, %r); " % str(REPO)
            + "; ".join(f"import benchmark.{n[:-3].replace('/', '.')}" for n in YARDSTICK)
            + "; print(sorted(m for m in sys.modules if m.startswith('stereovision')"
            " or m.split('.')[0] in ('jax', 'jaxlib', 'flax')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]"
