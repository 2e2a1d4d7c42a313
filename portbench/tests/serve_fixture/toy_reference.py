"""A stand-in for a plain reference, for the CPU tests of the serving
driver: the port's own teacher-forced ``forward`` on the weights the
driver hands over. It shares the model's code with the program, so it
tests the driver's plumbing (the prompts kept, the weights drawn again
from the set-up seed, each served token judged at its position), not
the model; a cell's reference is plain PyTorch that imports nothing of
the program. Its limit lies between what the tiny model's bf16 serving
reads (0 to 0.0098 over 12 seeds on the CPU: the decode path's rounding
flips a near tie now and then) and one served token altered (0.45 to
0.87 over 6)."""
import torch

from portbench.reference import served

LIMITS = {"logit_gap": {"at_most": 0.05}, "tokens_judged": {"at_least": 1}}


def judge(config, weights, calls, device):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Model, forward
    cfg = get_config(config["arch"])
    model = Model(cfg, None, "meta").to_empty(device=device)
    model.load_state_dict(weights)

    def logits(tokens, first):
        with torch.no_grad():
            return forward(cfg, model, {"tokens": tokens.to(device)})[
                :, first:]

    gap, judged = served.widest_gap(logits, calls, rows=2)
    return {"logit_gap": gap, "tokens_judged": judged}
