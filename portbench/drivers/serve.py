"""Driver of a served model: batches of greedy requests through the
port's serving engine.

The configuration is a ``"model"`` one: ``arch`` names the port's
configuration (``repro_torch.configs.get_config``), which is the model
that runs and whose vocabulary the prompts are drawn from (the tests
hold the file's sizes equal to it), ``flops`` the file that counts a
call's model FLOPs and ``reference`` the plain reference that judges
the served tokens (``reference/served.py`` says how). The workload
gives ``batch``, ``prompt_len`` and ``new_tokens``.

Set-up draws the weights from the set-up seed with the port's
``init_params`` on the card (float32, as the port keeps them) and builds
a ``ServingEngine`` whose cache holds the prompt and the new tokens. A
call is one ``generate`` of ``batch`` prompts of ``prompt_len`` ids each,
drawn from the call's seed, all of one length (the engine pads shorter
prompts on the right), decoding ``new_tokens`` greedy steps; its work is
its tokens, prompt and generated. After the window the program's
weights and engine are freed; the check draws the weights again from the
set-up seed, as fresh tensors keyed by parameter name, and hands them
with the kept calls to the reference.
"""
from __future__ import annotations

import gc
import pathlib
import time

import torch

from portbench import harness

SEED_MOD = 1 << 63          # torch.Generator takes seeds below 2**64
WORK_UNIT = "tokens"


class Driver:
    def __init__(self, config: dict, workload: dict, device: str,
                 root: pathlib.Path):
        self.config, self.device, self.root = config, device, root
        self.batch = int(workload["batch"])
        self.prompt_len = int(workload["prompt_len"])
        self.new_tokens = int(workload["new_tokens"])
        self.flops_per_call = int(self._file("flops").call_flops(
            config, self.batch, self.prompt_len, self.new_tokens))
        self.ref = self._file("reference")
        self.weight_seed = None
        self.cfg = self.engine = None
        self.timings = {}

    def _file(self, key: str):
        path = self.root / self.config[key]
        return harness.load_module(path, f"{key}_{path.stem}")

    def weights(self, seed: int):
        """The port's ``Model`` of the configuration, drawn from ``seed``
        on the driver's device."""
        from repro_torch.models.transformer import init_params
        gen = torch.Generator(device=self.device).manual_seed(seed % SEED_MOD)
        return init_params(self.cfg, gen, device=self.device)

    def setup(self, warm_seed: int) -> None:
        """Build and warm up; ``self.timings`` holds the seconds of each
        part, the warm call's prefill and decode by the engine's clock."""
        t0 = time.perf_counter()
        from repro_torch.configs import get_config
        from repro_torch.inference.engine import Request, ServingEngine
        self.cfg = get_config(self.config["arch"])
        self._request = Request
        t1 = time.perf_counter()
        self.weight_seed = warm_seed
        params = self.weights(warm_seed)
        if self.device != "cpu":
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        self.engine = ServingEngine(self.cfg, params,
                                    max_len=self.prompt_len + self.new_tokens)
        self.call(warm_seed)
        warm = self.engine.timings
        self.timings = {"import": t1 - t0, "weights": t2 - t1,
                        "warm_call": time.perf_counter() - t2,
                        "warm_prefill": warm["prefill_ms"] / 1e3,
                        "warm_decode": warm["decode_ms"] / 1e3}

    def prompts(self, seed: int) -> torch.Tensor:
        """(batch, prompt_len) ids of the model's vocabulary, drawn from
        ``seed`` on the host."""
        gen = torch.Generator().manual_seed(seed % SEED_MOD)
        return torch.randint(0, self.cfg.vocab, (self.batch, self.prompt_len),
                             generator=gen)

    def call(self, seed: int) -> tuple:
        prompts = self.prompts(seed)
        reqs = [self._request(prompt=row, max_new_tokens=self.new_tokens)
                for row in prompts.tolist()]
        served = self.engine.generate(reqs)
        kept = {"prompts": prompts,
                "served": torch.tensor(served, dtype=torch.long).reshape(
                    self.batch, self.new_tokens)}
        return kept, self.batch * (self.prompt_len + self.new_tokens)

    def facts(self) -> dict:
        return {"work_unit": WORK_UNIT, "batch": self.batch,
                "prompt_len": self.prompt_len, "new_tokens": self.new_tokens,
                "flops_per_call": self.flops_per_call}

    def free(self) -> None:
        self.engine = None
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def limits(self) -> dict:
        return dict(self.ref.LIMITS)

    def check(self, kept: list) -> dict:
        """``kept``: (seed, outputs) of the sampled calls."""
        model = self.weights(self.weight_seed)
        weights = {n: p.detach() for n, p in model.named_parameters()}
        del model
        return self.ref.judge(self.config, weights,
                              [out for _, out in kept], self.device)
