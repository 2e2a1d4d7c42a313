"""Roofline analysis from compiled dry-run artifacts (deliverable g).

Three terms per (arch × shape × mesh):

  compute    = HLO_FLOPs_per_chip / peak_FLOP/s
  memory     = HLO_bytes_per_chip / HBM_bw
  collective = wire_bytes_per_chip / link_bw

``cost_analysis()`` on a GSPMD-partitioned module reports **per-device**
FLOPs/bytes (verified experimentally: global HLO flops / n_chips). Collective
bytes are not in cost_analysis, so the post-optimization HLO text is parsed:
every all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute instruction contributes ring-model bytes-on-wire
((g-1)/g × payload for AG/RS/A2A, 2(g-1)/g for AR, 1 hop for permute).

MODEL_FLOPS uses the standard 6·N·T (train) / 2·N·T (inference) parameter
term plus the attention term; the ratio MODEL_FLOPS / (chips × HLO_FLOPs)
exposes remat/padding/dispatch overhead in the compiled module.

Port copy of ``src/repro/roofline/analysis.py``, kept as its own copy:
the port imports nothing of ``repro``. Unchanged, constants included:
``PEAK_FLOPS``, ``HBM_BW`` and ``LINK_BW`` stay the TPU v5e numbers of
the reference, because the roofline surrogate
(``scenarios/surrogate.py``) normalises every device model into that
frame. They are not the card's numbers.

Added: ``collectives_from_comm`` prices the collectives DTensor issued in
the port's dry run (``CommRecorder``, a ``CommDebugMode`` that keeps each
collective's payload and group) with the same ring model as
``parse_collectives``, which stays for HLO text.
"""
from __future__ import annotations

import dataclasses
import re

from torch.distributed.distributed_c10d import _resolve_process_group
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ArchConfig, ShapeConfig

# TPU v5e constants (assignment-specified)
PEAK_FLOPS = 197e12       # bf16 / chip
HBM_BW = 819e9            # bytes/s / chip
LINK_BW = 50e9            # bytes/s / ICI link

_DTYPE_BYTES = {
    "f64": 8, "s64": 8, "u64": 8, "f32": 4, "s32": 4, "u32": 4,
    "bf16": 2, "f16": 2, "s16": 2, "u16": 2, "f8e4m3": 1, "f8e5m2": 1,
    "s8": 1, "u8": 1, "pred": 1,
}

_COLL_RE = re.compile(
    r"=\s*((?:\([^)]*\))|(?:[a-z0-9]+\[[^\]]*\]\S*))\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\{\{([0-9,]+)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_COMP_HEADER_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->.*\{")
_CALL_RE = re.compile(
    r"(?:condition|body|to_apply|calls|true_computation|false_computation)"
    r"=%([\w.\-]+)")
_BRANCHES_RE = re.compile(r"branch_computations=\{([^}]*)\}")
_CONST_RE = re.compile(r"constant\((\d+)\)")


def _max_element_bytes(type_str: str) -> float:
    """Largest tuple element (== the full buffer for -start variants)."""
    best = 0.0
    for dt, dims in _SHAPE_RE.findall(type_str):
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        best = max(best, n * _DTYPE_BYTES.get(dt, 4))
    return best


@dataclasses.dataclass
class CollectiveSummary:
    counts: dict              # per type, trip-count-weighted dynamic counts
    wire_bytes: dict          # per type, aggregate across chips
    total_wire_bytes: float

    def to_json(self) -> dict:
        return {"counts": self.counts, "wire_bytes": self.wire_bytes,
                "total_wire_bytes": self.total_wire_bytes}


def _split_computations(hlo_text: str) -> dict:
    comps: dict = {}
    entry = None
    name = None
    for line in hlo_text.splitlines():
        m = _COMP_HEADER_RE.match(line.strip())
        if m and ("->" in line):
            name = m.group(1)
            comps[name] = []
            if line.strip().startswith("ENTRY"):
                entry = name
        elif name is not None:
            comps[name].append(line)
    return comps, entry


def _trip_count(cond_lines) -> int:
    """Loop bound heuristic: max integer constant in the condition
    computation (scan conditions compare the counter to the bound)."""
    best = 1
    for line in cond_lines:
        for c in _CONST_RE.findall(line):
            best = max(best, int(c))
    return best


def parse_collectives(hlo_text: str, n_chips: int) -> CollectiveSummary:
    """Trip-count-aware collective accounting.

    HLO prints a while-loop body once, but its collectives execute once per
    iteration; this walks the call graph from ENTRY multiplying by loop trip
    counts (parsed from the loop conditions) so scan-over-layers schedules
    are charged correctly.
    """
    comps, entry = _split_computations(hlo_text)
    counts: dict = {}
    wire: dict = {}

    def visit(name: str, mult: float, stack: frozenset) -> None:
        if name not in comps or name in stack:
            return
        lines = comps[name]
        stack = stack | {name}
        for line in lines:
            m = _COLL_RE.search(line)
            if m:
                type_str, op = m.group(1), m.group(2)
                payload = _max_element_bytes(type_str)
                g = n_chips
                gm = _GROUPS_RE.search(line)
                if gm:
                    g = len(gm.group(1).split(","))
                else:
                    gi = _GROUPS_IOTA_RE.search(line)
                    if gi:
                        g = int(gi.group(2))
                g = max(g, 1)
                if op == "all-reduce":
                    per_chip = 2 * (g - 1) / g * payload
                elif op == "collective-permute":
                    per_chip = payload
                else:  # all-gather / reduce-scatter / all-to-all
                    per_chip = (g - 1) / g * payload
                counts[op] = counts.get(op, 0) + mult
                wire[op] = wire.get(op, 0.0) + per_chip * n_chips * mult
            # nested computations
            if " while(" in line:
                calls = dict()
                for kind, callee in re.findall(
                        r"(condition|body)=%([\w.\-]+)", line):
                    calls[kind] = callee
                trips = _trip_count(comps.get(calls.get("condition"), []))
                if "body" in calls:
                    visit(calls["body"], mult * trips, stack)
            else:
                for callee in _CALL_RE.findall(line):
                    visit(callee, mult, stack)
                bm = _BRANCHES_RE.search(line)
                if bm:
                    for callee in re.findall(r"%([\w.\-]+)", bm.group(1)):
                        visit(callee, mult, stack)

    if entry:
        visit(entry, 1.0, frozenset())
    total = sum(wire.values())
    return CollectiveSummary({k: round(v, 1) for k, v in counts.items()},
                             wire, total)


# DTensor's collectives as ``CommDebugMode`` sees them (functional ops of
# ``_c10d_functional``, DTensor's own shard-dim all-to-all) -> HLO names
_COMM_OPS = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}


class CommRecorder(CommDebugMode):
    """``CommDebugMode`` that also records each collective's payload (its
    output's bytes, the gathered or scattered result, as the HLO parser
    prices it) and its process group: ``records`` is a list of (HLO
    name, payload bytes, group name); ``get_comm_counts()`` counts as
    ``CommDebugMode``'s does. It leaves out ``CommDebugMode``'s module
    tracker, which fails on a module called twice in one step (zamba2's
    shared block)."""

    def __init__(self):
        super().__init__()
        self.records: list = []

    def __enter__(self):
        self.comm_counts.clear()
        self.records = []
        TorchDispatchMode.__enter__(self)
        return self

    def __exit__(self, *args):
        TorchDispatchMode.__exit__(self, *args)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is DTensor for t in types):
            return NotImplemented  # DTensor turns it into local ops first
        out = func(*args, **(kwargs or {}))
        op = _COMM_OPS.get(getattr(func, "_opname", ""))
        if op is not None:
            self.comm_counts[func._overloadpacket] += 1
            group = next(a for a in reversed([*args, *(kwargs or {}).values()])
                         if isinstance(a, str))
            self.records.append((op, out.numel() * out.element_size(), group))
        return out


def collectives_from_comm(comm_mode: CommRecorder,
                          mesh) -> CollectiveSummary:
    """``CollectiveSummary`` of the collectives a ``CommRecorder`` saw on
    one rank of ``mesh`` (every rank runs the same program), priced by
    ``parse_collectives``' ring model: (g-1)/g of the payload for
    all-gather, reduce-scatter and all-to-all, 2(g-1)/g for all-reduce,
    one hop for a permute; g is the size of the collective's group (a
    mesh dim's, or the product of the dims DTensor flattened into one
    group), and wire bytes aggregate over the mesh's ranks."""
    n_chips = mesh.size()
    counts: dict = {}
    wire: dict = {}
    for op, payload, group in comm_mode.records:
        g = max(_resolve_process_group(group).size(), 1)
        if op == "all-reduce":
            per_chip = 2 * (g - 1) / g * payload
        elif op == "collective-permute":
            per_chip = payload
        else:
            per_chip = (g - 1) / g * payload
        counts[op] = counts.get(op, 0) + 1
        wire[op] = wire.get(op, 0.0) + per_chip * n_chips
    return CollectiveSummary(counts, wire, sum(wire.values()))


# ------------------------------------------------------------ analytic cost
def _fwd_flops(cfg: ArchConfig, b: int, s: int) -> float:
    """Forward FLOPs of one teacher-forced pass (global, all layers)."""
    d, dh = cfg.d_model, cfg.d_head
    t = b * s
    # attention projections (q, k, v, o)
    proj = 2 * t * d * (2 * cfg.n_heads * dh + 2 * cfg.n_kv_heads * dh)
    # attention core (QKᵀ + PV), causal ⇒ ×0.5; local layers see the window
    if cfg.is_attention_free:
        core = 0.0
    elif cfg.global_every and cfg.window:
        w = min(cfg.window, s)
        loc = cfg.n_layers * (1 - 1 / cfg.global_every)
        glo = cfg.n_layers / cfg.global_every
        core = 4 * b * cfg.n_heads * dh * (loc * s * w + glo * s * s * 0.5) \
            / cfg.n_layers
    else:
        w = min(cfg.window or s, s)
        core = 4 * b * cfg.n_heads * dh * s * min(w, s) * (0.5 if not cfg.window else 1.0)
    mlp_mult = 3 if cfg.act in ("swiglu", "geglu") else 2
    if cfg.family == "moe":
        t_eff = t * cfg.top_k * cfg.capacity_factor  # capacity-padded
        ffn = 2 * t_eff * mlp_mult * d * cfg.d_ff_expert + 2 * t * d * cfg.n_experts
    elif cfg.family in ("ssm", "hybrid"):
        ffn = 0.0
    else:
        ffn = 2 * t * mlp_mult * d * cfg.d_ff
    per_layer = proj + core + ffn
    if cfg.family in ("ssm", "hybrid"):
        d_in = cfg.ssm_expand * d
        n = cfg.ssm_state
        q = cfg.ssm_chunk
        nh = cfg.ssm_heads
        p = d_in // max(nh, 1)
        ssd = (2 * t * d * (2 * d_in + 2 * n + nh)       # in_proj
               + 2 * t * d_in * d                         # out_proj
               + (s // max(q, 1)) * b * nh *
               (2 * q * q * n / max(nh, 1) + 2 * q * q * p + 4 * q * n * p))
        if cfg.family == "ssm":
            per_layer = ssd
        else:
            # hybrid: mamba everywhere + one shared attn block per group
            shared = (proj + core + 2 * t * mlp_mult * d * cfg.d_ff)
            n_shared = cfg.n_layers // max(cfg.shared_attn_every, 1)
            return (cfg.n_layers * ssd + n_shared * shared
                    + 2 * t * d * cfg.vocab)
    total_layers = cfg.n_layers + (cfg.n_encoder_layers if cfg.family == "audio" else 0)
    if cfg.family == "audio":  # cross-attention adds one more attn per layer
        per_layer = per_layer + proj / 2 + 4 * b * s * cfg.n_audio_frames * cfg.n_heads * dh / 2
    return total_layers * per_layer + 2 * t * d * cfg.vocab  # + unembed


def analytic_cost(cfg: ArchConfig, shape: ShapeConfig, remat: str = "full",
                  n_chips: int = 1) -> tuple:
    """(flops_per_chip, hbm_bytes_per_chip) — analytic, trip-count-exact.

    Used for the compute/memory roofline terms because XLA's
    ``cost_analysis()`` counts while-loop (scan) bodies once instead of
    ×trip-count; validated against cost_analysis on trip-count-1 configs in
    tests/test_roofline.py.
    """
    b, s = shape.global_batch, shape.seq_len
    p_total = cfg.param_count()
    p_active = cfg.active_param_count()
    if shape.kind == "train":
        fwd = _fwd_flops(cfg, b, s)
        mult = 3.0 + (1.0 if remat == "full" else 0.33 if remat == "dots" else 0.0)
        flops = fwd * mult
        act_bytes = 14 * b * s * cfg.d_model * 2 * max(cfg.n_layers, 1)
        logits_bytes = 4 * b * s * cfg.vocab * 3
        # params: bf16 fwd/bwd/remat reads + fp32 grad w/r + AdamW p/mu/nu r+w
        param_bytes = p_total * (2 * (2 + (1 if remat == "full" else 0))
                                 + 4 * 2 + 4 * 6)
        hbm = act_bytes * 2.5 + logits_bytes + param_bytes
    elif shape.kind == "prefill":
        flops = _fwd_flops(cfg, b, s)
        act_bytes = 14 * b * s * cfg.d_model * 2 * max(cfg.n_layers, 1)
        hbm = act_bytes + p_active * 2 + 4 * b * s * cfg.vocab
    else:  # decode: one token
        d, dh = cfg.d_model, cfg.d_head
        flops = 2.0 * p_active * b
        kv_read = 0.0
        if not cfg.is_attention_free:
            n_kv_layers = (cfg.n_layers if cfg.family != "hybrid"
                           else cfg.n_layers // max(cfg.shared_attn_every, 1))
            if cfg.global_every and cfg.window:
                w = min(cfg.window, s)
                eff_s = (w * (1 - 1 / cfg.global_every)
                         + s / cfg.global_every)
            else:
                eff_s = s
            flops += 4.0 * n_kv_layers * b * eff_s * cfg.n_kv_heads * dh
            kv_read = n_kv_layers * b * eff_s * cfg.n_kv_heads * dh * 2 * 2
        ssm_read = 0.0
        if cfg.ssm_state:
            d_in = cfg.ssm_expand * d
            ssm_read = cfg.n_layers * b * (d_in // max(cfg.ssm_d_head, 1)) \
                * cfg.ssm_state * cfg.ssm_d_head * 4
            flops += cfg.n_layers * b * 6 * d_in * cfg.ssm_state
        hbm = p_active * 2 + kv_read + ssm_read + b * cfg.vocab * 4
    return flops / n_chips, hbm / n_chips


# --------------------------------------------------------------- model flops
def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Useful model FLOPs for the cell: the forward cost with *no* waste
    (capacity factor 1, no remat); ≈ 6·N·T (train) / 2·N·T (inference) plus
    the attention term, with window/hybrid structure accounted for."""
    import dataclasses as _dc
    ideal = (_dc.replace(cfg, capacity_factor=1.0)
             if cfg.family == "moe" else cfg)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return 3.0 * _fwd_flops(ideal, b, s)
    if shape.kind == "prefill":
        return _fwd_flops(ideal, b, s)
    # decode: one token against an s-deep cache
    param_term = 2.0 * ideal.active_param_count() * b
    if cfg.is_attention_free:
        attn = 0.0
    else:
        n_attn_layers = (cfg.n_layers // max(cfg.shared_attn_every, 1)
                         if cfg.family == "hybrid" else cfg.n_layers)
        if cfg.global_every and cfg.window:
            eff_s = (min(cfg.window, s) * (1 - 1 / cfg.global_every)
                     + s / cfg.global_every)
        else:
            eff_s = s
        attn = 4.0 * n_attn_layers * b * eff_s * cfg.n_kv_heads * cfg.d_head
    ssm = (cfg.n_layers * b * 6 * cfg.ssm_expand * cfg.d_model * cfg.ssm_state
           if cfg.ssm_state else 0.0)
    return param_term + attn + ssm


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float       # MODEL_FLOPS / (chips × HLO_FLOPs)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def roofline(flops_per_chip: float, bytes_per_chip: float,
             collective_wire_bytes: float, n_chips: int,
             mflops: float) -> Roofline:
    compute_s = flops_per_chip / PEAK_FLOPS
    memory_s = bytes_per_chip / HBM_BW
    collective_s = collective_wire_bytes / (n_chips * LINK_BW)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    total_hlo_flops = flops_per_chip * n_chips
    ratio = mflops / total_hlo_flops if total_hlo_flops else 0.0
    return Roofline(compute_s, memory_s, collective_s, dominant, mflops,
                    ratio)
