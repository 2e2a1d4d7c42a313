"""The serving driver end to end on the CPU: zamba2-1.2b's tiny preset, its
vocabulary halved, through the port's ``ServingEngine``, judged by the toy
reference and counted by the toy FLOP file of ``serve_fixture/``; and the
same run with a served token altered where it is produced, which the
check has to catch."""
import json
import pathlib
import time

import pytest
import torch

from portbench import harness
from portbench.reference import served

ROOT = pathlib.Path(__file__).resolve().parents[2]
CONFIG = json.loads(
    (ROOT / "portbench/tests/serve_fixture/model_config.json").read_text())
WORKLOAD = {"config": "zamba2-toy", "traffic": "toy", "driver": "serve",
            "batch": 2, "prompt_len": 12, "new_tokens": 4}
E2E = [{"name": n, "unit": u} for n, u in (
    ("sim_evals_per_s", "evals/s"), ("tokens_per_s", "tokens/s"),
    ("step_mfu", "%"), ("call_p90_ms", "ms"), ("setup_s", "s"))]


@pytest.fixture(autouse=True)
def tiny(toy_arch):
    """``get_config`` gives the model that the fixture's file describes."""


def run(seconds=0.3, seed=2 ** 31 + 77):
    cell = harness.Cell("zamba2-toy.toy", 1, CONFIG, WORKLOAD, E2E, [])
    return harness.run_cell(cell, seed, seconds, False, "cpu",
                            time.perf_counter(), ROOT)


def test_serve_runs_and_is_correct():
    result = run()
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {"tokens_per_s", "step_mfu",
                                      "call_p90_ms", "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["checks"]["tokens_judged"]["value"] == \
        min(result["attempted"], harness.CHECK_CALLS) * 2 * 4
    # the toy count: 2 FLOPs a parameter for every token but the last
    mfu = result["metrics"]["step_mfu"]["value"]
    rate = result["metrics"]["tokens_per_s"]["value"]
    assert mfu == pytest.approx(100 * rate * (2 * 200_000 * (12 + 3) / 16)
                                / 989.4e12)


def test_prompts_and_weights_come_from_the_seed():
    drv = harness.load_module(harness.PKG / "drivers" / "serve.py",
                              "serve").Driver(CONFIG, WORKLOAD, "cpu", ROOT)
    drv.setup(harness.call_seed(2 ** 31 + 3, harness.WARM_CALL))
    a, work = drv.call(123456789012345)
    b, _ = drv.call(123456789012345)
    assert work == 2 * (12 + 4)
    assert torch.equal(a["prompts"], b["prompts"])
    assert torch.equal(a["served"], b["served"])
    assert a["prompts"].shape == (2, 12) and a["served"].shape == (2, 4)
    assert int(a["prompts"].max()) < CONFIG["vocab_size"]
    first = dict(drv.engine.params.named_parameters())
    again = dict(drv.weights(drv.weight_seed).named_parameters())
    assert all(torch.equal(first[n], again[n]) for n in first)
    assert drv.facts()["flops_per_call"] == 2 * 200_000 * 2 * (12 + 3)


def test_an_altered_token_is_not_correct(monkeypatch):
    """Every request's second served token moved by one id where
    ``generate`` produces it."""
    from repro_torch.inference import engine
    real = engine.ServingEngine.generate

    def altered(self, requests, generator=None):
        out = real(self, requests, generator)
        return [[t if j != 1 else (t + 1) % CONFIG["vocab_size"]
                 for j, t in enumerate(row)] for row in out]

    monkeypatch.setattr(engine.ServingEngine, "generate", altered)
    result = run(seconds=0.05)
    assert result["correct"] is False
    assert result["checks"]["logit_gap"]["value"] > 0.05


def test_token_gaps_by_position():
    """Logits at position S - 1 + j judge served token j."""
    logits = torch.tensor([[[0.0, 2.0, 1.0], [3.0, 0.0, 0.5]]])
    assert token_gaps_list(logits, [[1, 2]]) == [[0.0, 2.5]]
    feed, first = served.teacher_forced(torch.tensor([[7, 8, 9]]),
                                        torch.tensor([[4, 5]]))
    assert feed.tolist() == [[7, 8, 9, 4]] and first == 2

    def logits_fn(tokens, first):
        # a model whose best next token is always 5
        out = torch.zeros(tokens.shape[0], tokens.shape[1] - first, 6)
        out[..., 5] = 1.0
        return out

    calls = [{"prompts": torch.tensor([[1, 2, 3]]),
              "served": torch.tensor([[5, 4]])}]
    assert served.widest_gap(logits_fn, calls) == (1.0, 2)


def token_gaps_list(logits, tokens):
    return served.token_gaps(logits, torch.tensor(tokens)).tolist()
