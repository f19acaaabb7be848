"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names; the reference loads nothing of the program."""

import ast
import subprocess
import sys

import pytest

from benchmark.harness import forbidden_modules
from benchmark.tests.conftest import ROOT, SMALL


def test_top_level_names_compared_whole():
    mods = ["faststyle_tpu_torch", "faststyle_tpu_torch.inference", "jax_like", "numpy", "flaxen"]
    assert forbidden_modules(mods) == []
    assert forbidden_modules(mods + ["faststyle_tpu.ops", "jaxlib", "jax.numpy", "flax"]) == [
        "faststyle_tpu.ops", "flax", "jax.numpy", "jaxlib"]


@pytest.mark.parametrize("folder", ["reference"])
def test_reference_imports_nothing_of_the_program(folder):
    for path in sorted((ROOT / "benchmark" / folder).glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in ("faststyle_tpu_torch", "faststyle_tpu", "jax", "jaxlib", "flax"), (
                    f"{path.name} imports {name}")


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_a_run_loads_no_jax(workload, bench_copy):
    """A whole small run on the CPU, in a fresh process."""
    code = (
        "import json, time, torch; torch.set_num_threads(1)\n"
        "from benchmark.harness import run_cell, forbidden_modules\n"
        "from benchmark.spec import Bench\n"
        f"run_cell(Bench({str(bench_copy.root)!r}), {workload!r}, 5, 0.5, True, 'cpu', time.perf_counter(), {SMALL[workload]!r})\n"
        "print(json.dumps(forbidden_modules()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_refuses_a_machine_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "stylize_4k_d4", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
