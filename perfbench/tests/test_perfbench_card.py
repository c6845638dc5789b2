"""A short run of each cell on the card, through the command itself."""
import json
import subprocess
import sys

import pytest

from perfbench.tests.helpers import ROOT

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_a_short_run_is_correct(cell, cuda_device):
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        cell, "--seed", "2147483659", "--seconds", "2",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
