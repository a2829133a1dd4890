"""On the card: each cell's command ends with a correct result line, and
the INT8 control at the cell's own size is not correct. Skips without a
CUDA device. (`python -m pytest benchmark/tests/test_bench_card.py` on a
machine with the card; a few minutes, the first run builds the kernels.)"""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = ["espcn-540p-b8", "styletransfer-candy-512-b4", "espcn-540p-serve", "espcn-540p-b1"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_command_prints_a_correct_line(card, cell):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          "3000000007", "--seconds", "2", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["failed"] == 0 and r["device"]["platform"] == "gpu"
    assert list(r)[-1] == "check"


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_int8_control_is_not_correct_at_the_cells_size(card, cell):
    import time

    from benchmark.harness import controls, core, spec

    c = spec.load_cell(cell)
    r = core.run_cell(c, 3100000009, 2.0, False, time.monotonic(),
                      program_factory=controls.Int8Program)
    assert not r["correct"], r["check"]
