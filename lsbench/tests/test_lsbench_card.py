"""On the card: one short run of each cell through the command the driver
runs, correct and with the contract's last line. Run on the chip with
``python3 -m pytest -q -m card lsbench/tests``."""
import json
import subprocess
import sys

import pytest

from lsbench import harness


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      harness.benchmark()["workloads"]])
def test_cell_runs_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "lsbench.run", "--workload", workload,
         "--seed", "2147483653", "--seconds", "5", "--trace", "0"],
        cwd=harness.REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
