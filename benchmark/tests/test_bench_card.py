"""On the card: one short run of each cell through the manifest's
command, its last line read as the contract has it. Skips without a card
(decided inside the test)."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness

CELLS = [c["name"] for c in harness.manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    man = harness.manifest()
    proc = subprocess.run([sys.executable, *man["command"][1:], "--workload", workload,
                           "--seed", str(2 ** 31 + 99), "--seconds", "3", "--trace", "1"],
                          cwd=harness.ROOT, capture_output=True, text=True, timeout=360,
                          env=dict(os.environ))
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0 and out["device"]["window_s"] > 0
    want = {m["name"] for m in harness.cell_metrics(man, workload, True)}
    assert set(out["metrics"]) == want
    for name, m in out["metrics"].items():
        if name.endswith("_roofline") or "mfu" in name:
            assert 0 < m["value"] <= 100
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")
