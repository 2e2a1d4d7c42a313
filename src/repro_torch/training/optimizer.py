"""AdamW with warmup-cosine schedule and global-norm clipping.

Port of ``src/repro/training/optimizer.py``. Parameters are fp32 masters;
first/second moments fp32. ``mu_dtype=bf16`` is available as a memory
trick for the largest models (halves the first moment's memory).

What changed: the state works on dicts of tensors keyed by parameter name
(``Model.named_parameters()``) instead of pytrees, and ``adamw_update``
writes the new parameters and moments into those tensors in place (a
functional copy of a 1.2 B-parameter model and its moments would double
their 13 GB). The arithmetic is the reference's, in its order, in
float32: the schedule and the bias corrections are float32 tensors, not
Python floats. ``torch.optim.AdamW`` is not used: it applies the weight
decay and the update in another order, which differs at float32
rounding.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    mu_dtype: str = "float32"      # "bfloat16" halves optimizer memory


def schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (a number or a tensor), float32:
    linear warmup, then a cosine down to ``min_lr_ratio`` of the peak."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    progress = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    progress = torch.clamp(progress, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(torch.tensor(math.pi, dtype=torch.float32,
                                   device=step.device) * progress))
    return cfg.peak_lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(cfg: OptimizerConfig,
                   params: Mapping[str, torch.Tensor]) -> dict:
    """``{"mu", "nu", "step"}``: zero moments keyed like ``params`` (mu in
    ``mu_dtype``, nu float32) and a zero int32 step, on the parameters'
    device."""
    mu_dt = getattr(torch, cfg.mu_dtype)
    device = next(iter(params.values())).device
    return {
        "mu": {k: torch.zeros_like(p, dtype=mu_dt) for k, p in params.items()},
        "nu": {k: torch.zeros_like(p, dtype=torch.float32)
               for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor (float32), summed tensor
    by tensor as the reference sums its leaves."""
    total = None
    for x in tensors:
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], opt_state: dict):
    """One AdamW step, in place: ``params`` and ``opt_state``'s moments and
    step are overwritten. Returns (params, opt_state, metrics), metrics
    ``{"grad_norm", "lr"}`` float32 tensors."""
    names = list(params)
    step = opt_state["step"] + 1
    gnorm = global_norm(grads[k] for k in names)
    scale = torch.minimum(torch.ones_like(gnorm),
                          cfg.clip_norm / torch.clamp_min(gnorm, 1e-9))
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                    device=stepf.device), stepf)
    c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                    device=stepf.device), stepf)
    for k in names:
        p, mu, nu = params[k], opt_state["mu"][k], opt_state["nu"][k]
        g = grads[k].float() * scale
        mu_new = b1 * mu.float() + (1 - b1) * g
        nu.copy_(b2 * nu + (1 - b2) * g * g)
        mhat = mu_new / c1
        vhat = nu / c2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p
        p.sub_(lr * delta)
        mu.copy_(mu_new)
    opt_state["step"].copy_(step)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
