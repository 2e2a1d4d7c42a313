"""On the card: the program against the plain reference on the frozen
recordings, the float32 control, and a whole short run of run.py.

    python -m pytest portbench/tests -m cuda

Each test decides inside itself whether a card is there."""
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import compare

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = ("gemm.ga", "hotspot.pso", "gemm.random", "hotspot.de")


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the budget scan has no CPU kernel")


def driver_of(cell_name, runs):
    cell = harness.load_cell(ROOT, cell_name)
    wl = {**cell.workload, "runs": runs}
    d = harness.load_module(harness.PKG / "drivers" / "free_run.py",
                            "free_run").Driver(cell.config, wl, "cuda", ROOT)
    d.setup(harness.call_seed(1, harness.WARM_CALL))
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_is_the_reference_and_control_is_not(cell):
    need_card()
    d = driver_of(cell, 2048)
    for seed in (2 ** 31 + 5, 77):
        got, _ = d.call(seed)
        want = d.reference([seed])[0]
        assert compare.compare(got, want) == {
            "runs_off": 0, "spend_gap_s": 0.0, "runs_compared": 512}
        low = d.reference([seed], spend_dtype=np.float32)[0]
        assert compare.compare(low, want)["spend_gap_s"] > 0


@pytest.mark.cuda
def test_a_short_run_prints_a_correct_result():
    need_card()
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "hotspot.pso",
         "--seed", str(2 ** 31 + 9), "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert list(result)[-1] == "checks"
    assert result["device"]["busy_s"] > 0
    assert "scan_roofline" in result["metrics"]
    assert "d2h_ms_per_call" in result["metrics"]
