"""Dense MLP and Mixture-of-Experts layers.

Port of ``src/repro/models/mlp.py``: ``make_mlp`` / ``apply_mlp`` become
the ``MLP`` module and ``make_moe`` / ``apply_moe`` the ``MoE`` module,
with the reference's parameter names (``wi``, ``wg``, ``wo``; the MoE's
``router`` (d, E), ``wi`` / ``wg`` (E, d, ff), ``wo`` (E, ff, d)), shapes
and arithmetic: products in the compute dtype, left to ``torch.matmul``
and ``torch.einsum`` as the reference leaves them to XLA, with the
reference's ``annotate`` layout pins and each weight's FSDP shard
gathered where it is used (``gathered``; no-ops without DTensors).

MoE is the reference's per-row capacity dispatch, step for step (no
kernel of the reference's computes it, so none of the port's does): the
router's logits in float32, softmax, the top k renormalised; each
(token, choice)'s position within its expert from a stable sort of the
row's S·K expert ids; choices at or past the expert's capacity
(``capacity_factor`` × S·K / E, rounded up) dropped; K scatter-adds into
a (B, E, capacity, D) buffer, the three expert products, K gathers
weighted by the renormalised probability. What changed: ``jax.lax.top_k``
puts the lower expert first among equal probabilities, which
``torch.topk`` does not promise, so the top k come from a stable
descending sort (with bf16 router logits, ties among 128 experts are
common, and one broken the other way changes which tokens are dropped).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..configs.base import ArchConfig
from ..distribution.annotate import (annotate, gathered, shard_to_rows,
                                     site_placements, summed_map)
from .layers import activation, dense_init, param


class MLP(nn.Module):
    def __init__(self, cfg: ArchConfig, d: int, ff: int, gen=None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.wi = param(dense_init(gen, d, ff, device=device))
        self.wo = param(dense_init(gen, ff, d, device=device))
        self.wg = (param(dense_init(gen, d, ff, device=device))
                   if cfg.act in ("swiglu", "geglu") else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        x = annotate(x, "dp", None, None)  # whole sequences (2d_seq)
        up = annotate(x @ gathered(self.wi.to(dt), x), "dp", None, "tp")
        gate = (annotate(x @ gathered(self.wg.to(dt), x), "dp", None, "tp")
                if self.wg is not None else None)
        h = activation(self.cfg, gate, up)
        return h @ gathered(self.wo.to(dt), h)


class MoE(nn.Module):
    """``make_moe`` + ``apply_moe``: aux-loss-free top-k routing with
    per-row capacity."""

    def __init__(self, cfg: ArchConfig, gen=None, device=None):
        super().__init__()
        self.cfg = cfg
        d, e, ff = cfg.d_model, cfg.n_experts, cfg.d_ff_expert

        def normal(*shape, scale):
            return param(torch.randn(shape, generator=gen, device=device)
                         * scale)

        self.router = param(dense_init(gen, d, e, scale=0.02, device=device))
        self.wi = normal(e, d, ff, scale=d ** -0.5)
        self.wo = normal(e, ff, d, scale=ff ** -0.5)
        self.wg = (normal(e, d, ff, scale=d ** -0.5)
                   if cfg.act in ("swiglu", "geglu") else None)

    def route(self, x: torch.Tensor, router: torch.Tensor | None = None
              ) -> tuple:
        """(top_p (B, S, K) float32 renormalised, top_e (B, S, K), pos
        (B, S, K) each choice's slot in its expert, keep (B, S, K): the
        slot lies below the capacity ``cap``), and ``cap``. ``router``:
        the router's weight (default the module's own)."""
        cfg = self.cfg
        b, s, _ = x.shape
        e, k = cfg.n_experts, cfg.top_k
        cap = int(-(-s * k * cfg.capacity_factor // e))
        router = self.router if router is None else router
        logits = (x @ router.to(x.dtype)).float()                # (B,S,E)
        probs = torch.softmax(logits, dim=-1)
        # the lower expert first among equal probabilities, as lax.top_k
        top_p, top_e = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
        top_p, top_e = top_p[..., :k], top_e[..., :k]
        top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
        # position within expert = index in the stable sort - the first
        # index of that expert
        flat_e = top_e.reshape(b, s * k)
        order = torch.argsort(flat_e, dim=-1, stable=True)       # (B, SK)
        sorted_e = torch.gather(flat_e, -1, order)
        first = torch.searchsorted(sorted_e, sorted_e, side="left")
        pos_sorted = torch.arange(s * k, device=x.device)[None] - first
        pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
        pos = pos.reshape(b, s, k)
        return top_p, top_e, pos, pos < cap, cap

    def _dispatch(self, x, router) -> tuple:
        """Route each row and scatter its kept choices into a (B, E, cap,
        D) buffer: (buf, top_p, top_e, pos_c, keep)."""
        cfg = self.cfg
        b, s, d = x.shape
        dt = x.dtype
        top_p, top_e, pos, keep, cap = self.route(x, router)
        pos_c = torch.clamp_max(pos, cap - 1)
        rows = torch.arange(b, device=x.device)[:, None]
        buf = torch.zeros((b, cfg.n_experts, cap, d), dtype=dt,
                          device=x.device)
        for kk in range(cfg.top_k):  # dropped choices add 0 at slot cap - 1
            contrib = torch.where(keep[:, :, kk, None], x, 0).to(dt)
            buf = buf.index_put((rows, top_e[:, :, kk], pos_c[:, :, kk]),
                                contrib, accumulate=True)
        return buf, top_p, top_e, pos_c, keep

    def _experts(self, buf):
        dt = buf.dtype
        up = torch.einsum("becd,edf->becf", buf,
                          gathered(self.wi.to(dt), buf))
        gate = (torch.einsum("becd,edf->becf", buf,
                             gathered(self.wg.to(dt), buf))
                if self.wg is not None else None)
        h = activation(self.cfg, gate, up)
        return torch.einsum("becf,efd->becd", h, gathered(self.wo.to(dt), h))

    def _combine(self, out, top_p, top_e, pos_c, keep):
        """Each token's K expert outputs, weighted: (B, S, D)."""
        b, s = top_e.shape[:2]
        rows = torch.arange(b, device=out.device)[:, None]
        y = torch.zeros((b, s, out.shape[-1]), dtype=out.dtype,
                        device=out.device)
        for kk in range(self.cfg.top_k):
            gathered = out[rows, top_e[:, :, kk], pos_c[:, :, kk]]
            w = (top_p[:, :, kk, None] * keep[:, :, kk, None]).to(out.dtype)
            y = y + gathered * w
        return y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, S, D) -> (B, S, D). DTensors: the dispatch runs on each
        rank's batch rows (``local_map``; the router is gathered whole),
        the expert products on DTensors (experts on tp where they divide,
        as the reference's all-to-all lays them out), and their output
        goes back to rows as the reference's layout moves it: split
        further, over the mesh dims that split the experts (or hold the
        products' partial sums), where the rank's rows divide, by an
        all-to-all (a reduce-scatter for partial sums), so each rank
        combines its share of the rows; gathered back to the rank's rows
        elsewhere (``_rows_back``)."""
        if not isinstance(x, DTensor):
            buf, *routing = self._dispatch(x, self.router)
            return self._combine(self._experts(buf), *routing)
        mesh = x.device_mesh
        rows = site_placements(x, "dp", None, None)
        whole = (Replicate(),) * mesh.ndim
        x = x.redistribute(mesh, rows)
        router = self.router.redistribute(mesh, whole)
        buf, *routing = summed_map(
            self._dispatch, out_placements=(list(rows),) * 5,
            in_placements=(list(rows), list(whole)))(x, router)
        out = self._experts(annotate(buf, "dp", "tp", None, None))
        back = _rows_back(out, rows)
        out = _experts_to_rows(out, back)
        routing = [t.redistribute(mesh, back) for t in routing]
        return summed_map(self._combine, out_placements=list(back),
                          in_placements=(list(back),) * 5)(out, *routing)


def _rows_back(out, rows) -> tuple:
    """The placements the experts' output (B, E, cap, D) goes back to
    before the combine: the rows' own (``rows``), split further on each
    mesh dim whose ranks hold other experts (``Shard(1)``) or partial sums
    of the products (``Partial``) where the rows left on a rank divide by
    its size."""
    mesh = out.device_mesh
    left = out.shape[0]
    for i, p in enumerate(rows):
        if p == Shard(0):
            left //= mesh.size(i)
    back = list(rows)
    for i, p in enumerate(out.placements):
        n = mesh.size(i)
        if (n > 1 and rows[i] == Replicate() and left % n == 0
                and (p == Shard(1) or isinstance(p, Partial))):
            back[i] = Shard(0)
            left //= n
    return tuple(back)


def _experts_to_rows(out, back):
    """The experts' output laid out as ``back``: partial sums
    reduce-scattered into rows (``redistribute``), experts sent to their
    rows by explicit all-to-alls (``shard_to_rows``)."""
    mesh = out.device_mesh
    have = tuple(out.placements)
    moves = [i for i, p in enumerate(have) if p == Shard(1)
             and back[i] == Shard(0)]
    first = tuple(p if i in moves else back[i] for i, p in enumerate(have))
    out = shard_to_rows(out.redistribute(mesh, first), 1, moves)
    return out.redistribute(mesh, back)
