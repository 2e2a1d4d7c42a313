"""On the card: the serving driver through the port's kernels, on
zamba2-1.2b's tiny preset (its vocabulary halved), judged by the toy
reference.

    python -m pytest portbench/tests -m cuda

Each test decides inside itself whether a card is there."""
import json
import pathlib
import time

import pytest
import torch

from portbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
CONFIG = json.loads(
    (ROOT / "portbench/tests/serve_fixture/model_config.json").read_text())


@pytest.mark.cuda
def test_serve_on_the_card_is_correct(toy_arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: flash attention and the SSD have "
                    "no CPU kernel")
    wl = {"config": "zamba2-toy", "traffic": "toy", "driver": "serve",
          "batch": 4, "prompt_len": 256, "new_tokens": 8}
    e2e = [{"name": n, "unit": "u"} for n in (
        "sim_evals_per_s", "tokens_per_s", "step_mfu", "call_p90_ms",
        "setup_s")]
    cell = harness.Cell("zamba2-toy.card", 1, CONFIG, wl, e2e, [])
    result = harness.run_cell(cell, 2 ** 31 + 11, 2.0, False, "cuda",
                              time.perf_counter(), ROOT)
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {"tokens_per_s", "step_mfu",
                                      "call_p90_ms", "setup_s"}
    assert result["checks"]["tokens_judged"]["value"] == 2 * 4 * 8
    assert result["device"]["memory_peak_bytes"] > 0
