"""On a card: each cell through the command, a short window, correct."""

import json
import subprocess
import sys

import pytest

from benchmark.spec import Bench
from benchmark.tests.conftest import ROOT


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in Bench().spec["workloads"]])
def test_cell_runs_and_is_correct(card, workload):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", workload, "--seed", str(2**31 + 99),
                          "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["failed"] == 0
