"""How a served model's greedy tokens are judged against a plain
reference.

The reference runs once over each prompt followed by its served tokens
(teacher forcing). Its logits at position S - 1 + j of a prompt of S
tokens predict served token j; that token's gap is how far its logit
lies below the reference's best there: 0 where the program chose the
reference's first choice, small where the two sides' rounding flips a
near tie, large where a token is wrong. The reading is the widest gap
over every token judged. Greedy tokens only: a sampled token may lie
anywhere below the best.

A configuration's reference file (``reference/<file>.py``, named by the
configuration's ``reference``) gives ``LIMITS`` and ``judge(config,
weights, calls, device)``, where ``weights`` maps the port's parameter
names to tensors made afresh from the set-up seed and each call is a
dict with ``prompts`` (B, S) and ``served`` (B, N) token ids;
``judge`` can read its numbers with ``widest_gap``.
"""
from __future__ import annotations

import torch


def token_gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``logits`` (..., V), ``tokens`` (...): how far each token's logit
    lies below the best of its row, in float32."""
    lf = logits.float()
    return lf.max(-1).values - lf.gather(-1, tokens[..., None])[..., 0]


def teacher_forced(prompts: torch.Tensor, served: torch.Tensor) -> tuple:
    """The tokens to feed, (B, S + N - 1), and the first position whose
    logits predict a served token (S - 1)."""
    return torch.cat([prompts, served[:, :-1]], 1), prompts.shape[1] - 1


def widest_gap(logits_fn, calls: list, rows: int = 1) -> tuple:
    """(widest gap, tokens judged) over every served token of ``calls``,
    ``rows`` requests at a time. ``logits_fn(tokens, first)`` gives the
    reference's logits (b, L - first, V) of positions ``first`` to the
    end of ``tokens`` (b, L)."""
    worst, judged = 0.0, 0
    for call in calls:
        prompts, served = call["prompts"], call["served"]
        for i in range(0, prompts.shape[0], rows):
            feed, first = teacher_forced(prompts[i:i + rows],
                                         served[i:i + rows])
            logits = logits_fn(feed, first)
            gaps = token_gaps(logits, served[i:i + rows].to(logits.device))
            if gaps.numel():
                worst = max(worst, float(gaps.max()))
            judged += gaps.numel()
    return worst, judged
