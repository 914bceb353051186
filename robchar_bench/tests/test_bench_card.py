"""On the card: each cell's run comes out correct, and its control at the
cell's own size fails the cell's limits.  Skips without a CUDA device.

    python3 -m pytest robchar_bench/tests/test_bench_card.py -q
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from robchar_bench import control, harness

BENCH = harness.load_json(harness.bench_path())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_run_is_correct(card, cell):
    proc = subprocess.run(
        [sys.executable, "-m", "robchar_bench.run", "--workload", cell,
         "--seed", "2147483999", "--seconds", "3", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ))
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(card, cell):
    spec = harness.cell_spec(BENCH, cell)
    rows = control.readings(spec, [2147483998], 1, log=lambda *a: None)
    row = next(iter(rows.values()))
    assert harness.passes(harness.judge(spec, row["program"])), row
    assert not harness.passes(harness.judge(spec, row["control"])), row
