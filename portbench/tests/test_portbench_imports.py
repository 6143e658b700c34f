"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names; the reference uses neither the port."""

import subprocess
import sys
from pathlib import Path

from conftest import ROOT

from portbench.harness import guard

BENCH = ROOT / "portbench"


def _sources():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]


def test_no_source_imports_a_forbidden_module():
    for path in _sources():
        assert not guard.imported_names(path) & guard.FORBIDDEN, path


def test_reference_imports_numpy_and_torch_only():
    for path in (BENCH / "reference").glob("*.py"):
        assert guard.imported_names(path) <= {"__future__", "math", "numpy", "torch"}, path


def test_names_are_compared_whole():
    assert guard.loaded_forbidden(["multimodars_torch", "multimodars_torch.ops",
                                   "benchmark", "jaxtyping", "flaxen"]) == []
    assert guard.loaded_forbidden(["multimodars.shim", "jax.numpy", "bench"]) == [
        "bench", "jax", "multimodars"]


RUN_TINY = """
import sys, time
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from conftest import tiny_cell, CPU_CARD
import portbench.run as run
from portbench.harness import guard
cell = tiny_cell("oct280-single.synthetic")
res, _ = run.measure(cell, 5, 0.2, False, "cpu", lambda: None, CPU_CARD, lambda m: None,
                     time.perf_counter())
assert res["correct"], res
print(sorted({{n.split(".")[0] for n in sys.modules}} & guard.FORBIDDEN))
"""


def test_a_run_loads_no_forbidden_module():
    code = RUN_TINY.format(root=str(ROOT), tests=str(Path(__file__).parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
