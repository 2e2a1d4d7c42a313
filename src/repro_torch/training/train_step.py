"""Train-step factory: loss, microbatch gradient accumulation, remat.

Port of ``src/repro/training/train_step.py``. ``make_train_step`` closes
over the arch/optimizer configs and returns ``train_step(state, batch) ->
(state, metrics)``; the state is ``{"params": Model, "opt": {"mu", "nu",
"step"}}`` (``init_train_state``), the moments keyed by parameter name.

What changed: the reference's pure, jitted step with donated state
becomes an eager step that updates the state in place (AdamW writes the
parameters and moments it is given). Gradients come from
``torch.autograd.grad``; microbatches are a Python loop that sums the
gradients in float32 from zero, then scales them by 1/n, as the
reference's ``lax.scan`` does. The remat policy goes to ``forward``,
which applies it per layer body; the flash-attention and SSD call sites
differentiate through their own backward (``models/attention.py``,
``models/mamba2.py``). With DTensor parameters and batch (the dry run,
phase 12) the gold logit is the reference's iota-mask reduction, the
logsumexp is taken on each rank's vocab shard (``_sharded_logsumexp``), a
microbatch is the same slice of each rank's rows where they split, else
the reference's global rows (``_split``), and a (micro)batch whose rows
the batch axes do not divide is padded with rows that are no token up to
a multiple of their ranks, as GSPMD pads it (``_global_rows``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                     distribute_tensor)
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..distribution.annotate import (batch_ranks, current_layout,
                                     reinstall, resolve_spec, summed_map)
from ..distribution.sharding import placements
from ..models.transformer import Model, _unembed, forward, init_params
from .optimizer import OptimizerConfig, adamw_update, init_opt_state


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    remat: str = "full"           # none | dots | full
    z_loss: float = 1e-4          # logit norm regularizer (stability)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Mean next-token CE (fp32). logits: (B,S,V); targets: (B,S)
    integer. The gold logit by ``gather``, 0 for a target outside the
    vocabulary (the reference's iota-mask reduction picks the same one
    value, or none)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    t = targets.long()
    vocab = logits.shape[-1]
    gold = torch.where((t >= 0) & (t < vocab), torch.gather(
        logits, -1, t.clamp(0, vocab - 1)[..., None])[..., 0], 0.0)
    loss = (lse - gold).mean()
    if z_loss:
        loss = loss + z_loss * torch.square(lse).mean()
    return loss


def init_train_state(cfg: ArchConfig, opt_cfg: OptimizerConfig,
                     generator: torch.Generator | None = None, *,
                     device=None) -> dict:
    """``{"params": Model, "opt": {"mu", "nu", "step"}}`` of ``cfg`` on
    ``device`` (the card unless ``"cpu"`` is asked for), the weights drawn
    from ``generator`` (default: seed 0 on that device)."""
    params = init_params(cfg, generator, device=device)
    return {"params": params,
            "opt": init_opt_state(opt_cfg, dict(params.named_parameters()))}


def _iota_like(logits: DTensor, device) -> DTensor:
    """0 .. V-1 as a DTensor sharded as the last dim of ``logits``,
    replicated on every other mesh dim (each rank makes its own slice)."""
    last = logits.ndim - 1
    mesh = logits.device_mesh
    want = tuple(Shard(0) if p == Shard(last) else Replicate()
                 for p in logits.placements)
    return distribute_tensor(torch.arange(logits.shape[-1], device=device),
                             mesh, want, src_data_rank=None)


class _ShardLSE(torch.autograd.Function):
    """The logsumexp of the last dim of ``x``, a rank's local shard of
    logits sharded on that dim over the mesh dims ``groups``: the shard's
    max and its sum of ``exp(x - max)`` are combined by a max and a sum
    all-reduce, so that no rank holds more than its shard; the gradient
    is the softmax on the shard."""

    @staticmethod
    def forward(ctx, x, groups):
        m = x.amax(-1)
        for g in groups:
            m = funcol.all_reduce(m, "max", g)
        total = torch.exp(x - m[..., None]).sum(-1)
        for g in groups:
            total = funcol.all_reduce(total, "sum", g)
        lse = m + torch.log(total)
        ctx.save_for_backward(x, lse)
        return lse

    @staticmethod
    def backward(ctx, grad):
        x, lse = ctx.saved_tensors
        return grad[..., None] * torch.exp(x - lse[..., None]), None


def _sharded_logsumexp(logits):
    """``torch.logsumexp`` of the last dim of DTensor ``logits``. Logits
    sharded on it (a vocab on the model axis) take it on each rank's
    shard (``_ShardLSE``), where DTensor would gather them whole; the
    result is laid out as the logits' other dims."""
    last = logits.ndim - 1
    mesh, pl = logits.device_mesh, tuple(logits.placements)
    dims = [i for i, p in enumerate(pl) if p == Shard(last)
            and mesh.size(i) > 1]
    if not dims or any(isinstance(p, Partial) for p in pl):
        return torch.logsumexp(logits, dim=-1)
    groups = [(mesh, i) for i in dims]
    out = tuple(Replicate() if p == Shard(last) else p for p in pl)
    return summed_map(lambda x: _ShardLSE.apply(x, groups),
                      out_placements=list(out), in_placements=(list(pl),))(
        logits)


def _ce_chunk(cfg: ArchConfig, params: Model, xb, tb, z_loss: float):
    """One chunk's (sum of masked CE, count of real targets)."""
    logits = _unembed(cfg, params, xb)            # (B, chunk, V) fp32
    sharded = isinstance(logits, DTensor)
    lse = (_sharded_logsumexp(logits) if sharded
           else torch.logsumexp(logits, dim=-1))
    valid = (tb >= 0).float()
    if sharded:
        # the reference's iota-mask reduction: a gather across vocab-sharded
        # logits has no sharding DTensor can keep; the masked sum stays
        # sharded (the same value: one term is nonzero). The iota is laid
        # out as the logits' vocab, so each rank's mask covers its shard
        vocab = _iota_like(logits, tb.device)
        gold = torch.where(vocab == tb.clamp_min(0)[..., None], logits,
                           0.0).sum(-1)
    else:
        gold = torch.gather(logits, -1, tb.clamp_min(0)[..., None])[..., 0]
    loss_sum = torch.sum((lse - gold) * valid)
    if z_loss:
        loss_sum = loss_sum + z_loss * torch.sum(torch.square(lse) * valid)
    return loss_sum, valid.sum()


def _recompute_here() -> tuple:
    """A chunk's (forward, recompute) contexts: the recompute runs under
    the annotation mesh the forward ran under (on the card it runs on
    autograd's device thread, where this thread's is not installed)."""
    return contextlib.nullcontext(), reinstall()


def chunked_cross_entropy(cfg: ArchConfig, params: Model, x: torch.Tensor,
                          targets: torch.Tensor, z_loss: float = 0.0,
                          chunk: int = 512) -> torch.Tensor:
    """CE computed per sequence chunk so the (B,S,V) logits never
    materialize. Each chunk's body is checkpointed: the backward
    recomputes its logits, under the forward's annotation mesh. Pad
    targets are -1 and leave the mean."""
    b, s, _ = x.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    targets = targets.long()
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad), value=-1)
    loss_sum = count = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s + pad, chunk):
        ls, n = checkpoint(_ce_chunk, cfg, params, x[:, i:i + chunk],
                           targets[:, i:i + chunk], z_loss,
                           use_reentrant=False, context_fn=_recompute_here)
        loss_sum, count = loss_sum + ls, count + n
    return loss_sum / torch.clamp_min(count, 1.0)


def make_loss_fn(cfg: ArchConfig, tc: TrainConfig) -> Callable:
    def loss_fn(params: Model, batch: dict) -> torch.Tensor:
        tokens = batch["tokens"].long()
        model_batch = dict(batch)
        model_batch["tokens"] = tokens[:, :-1]
        if "positions" in model_batch:
            model_batch["positions"] = model_batch["positions"][:, :-1]
        x = forward(cfg, params, model_batch, remat=tc.remat,
                    pre_logits=True)
        return chunked_cross_entropy(cfg, params, x, tokens[:, 1:],
                                     tc.z_loss)
    return loss_fn


def _split(v: torch.Tensor, i: int, n: int, ranks: int = 1,
           pad: int = 0) -> torch.Tensor:
    """Microbatch ``i`` of ``n``: rows i·B/n .. (i+1)·B/n. A DTensor batch
    whose ranks' rows split into ``n``, into as many rows as the batch
    axes' ``ranks`` divide, takes the same slice of each rank's own rows
    (no collective; the microbatches hold other rows than the plain
    split, their sum is the same); otherwise it takes the global rows, as
    the reference's split does, padded (``_global_rows``)."""
    if isinstance(v, DTensor):
        local = v.to_local()
        if local.shape[0] % n or (v.shape[0] // n) % ranks:
            return _global_rows(v, i, n, ranks, pad)
        size = local.shape[0] // n
        return DTensor.from_local(local[i * size:(i + 1) * size],
                                  v.device_mesh, v.placements,
                                  run_check=False)
    size = v.shape[0] // n
    return v[i * size:(i + 1) * size]


def _global_rows(v: DTensor, i: int, n: int, ranks: int,
                 pad: int) -> DTensor:
    """Rows i·B/n .. (i+1)·B/n of the DTensor batch leaf ``v``: gathered
    whole on every rank (an all-gather of the inputs, which need no
    gradient) and sliced; padded with rows of ``pad`` up to a multiple of
    the batch axes' ``ranks``, as GSPMD pads a dim its shards do not
    divide, so that the "dp" pins keep every batch axis and each rank
    computes its own rows (one a rank where there are fewer rows than
    ranks); each rank keeps its rows of the slice as those pins lay them
    out (no collective). A pad row's tokens (-1) are no token: their
    embedding is zero and they are no target, so they leave the loss and
    the gradients."""
    mesh = v.device_mesh
    size = v.shape[0] // n
    whole = v.redistribute(mesh, (Replicate(),) * mesh.ndim).to_local()
    rows = whole[i * size:(i + 1) * size]
    extra = (-size) % ranks
    if extra:
        rows = torch.cat([rows, rows.new_full((extra, *rows.shape[1:]),
                                              pad)])
    want = placements(mesh, resolve_spec(mesh, current_layout(), rows.shape,
                                         "dp"))
    return distribute_tensor(rows, mesh, want, src_data_rank=None)


def _microbatch(batch: dict, i: int, n: int) -> dict:
    """Microbatch ``i`` of ``n`` of every leaf (``_split``); tokens pad
    with -1."""
    ranks = batch_ranks()
    return {k: _split(v, i, n, ranks, -1 if k == "tokens" else 0)
            for k, v in batch.items()}


def make_train_step(cfg: ArchConfig, opt_cfg: OptimizerConfig,
                    tc: TrainConfig = TrainConfig()) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``: the batch (numpy
    arrays or tensors, tokens (B, S+1)) goes to the parameters' device;
    the state is updated in place and returned; metrics ``{"loss",
    "grad_norm", "lr"}`` are float32 tensors."""
    loss_fn = make_loss_fn(cfg, tc)

    def value_and_grad(model, params, mb):
        loss = loss_fn(model, mb)
        return loss.detach(), torch.autograd.grad(loss, list(params.values()))

    def train_step(state: dict, batch: dict):
        model = state["params"]
        params = dict(model.named_parameters())
        batch = {k: torch.as_tensor(v, device=model.embed.device)
                 for k, v in batch.items()}
        if tc.microbatches > 1:
            n = tc.microbatches
            rows = batch["tokens"].shape[0]
            if rows % n:
                raise ValueError(f"batch {rows} not divisible by {n} "
                                 f"microbatches")
            loss = torch.zeros((), dtype=torch.float32,
                               device=model.embed.device)
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in params.values()]
            for i in range(n):
                mb_loss, mb_grads = value_and_grad(
                    model, params, _microbatch(batch, i, n))
                for acc, g in zip(grads, mb_grads):
                    acc.add_(g)
                loss = loss + mb_loss
            inv = 1.0 / n
            loss = loss * inv
            for g in grads:
                g.mul_(inv)
        else:
            if isinstance(batch["tokens"], DTensor):
                batch = _microbatch(batch, 0, 1)
            loss, grads = value_and_grad(model, params, batch)
        _, _, metrics = adamw_update(opt_cfg, params,
                                     dict(zip(params, grads)), state["opt"])
        metrics["loss"] = loss
        return state, metrics

    return train_step
