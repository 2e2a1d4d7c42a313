"""The port's own ``hybrid_moe`` family (``granite-4.0-h-small-ep8``) on the
CPU at its tiny preset (one attention layer among three Mamba layers, 16
routed experts, top 4, 2 of them held): against the benchmark's plain
reference (``portbench/reference/granite4h.py``, loaded by path as the
benchmark's harness loads it), the expert shares against the uncut
layer, the dropless routing, the registry, and its spans and counters.

Tolerances. The reference is the same mathematics in float32, the
teacher-forced forward over the whole sequence. In float32 (the port's
``COMPUTE_DTYPE``, ``CACHE_DTYPE`` and ``mamba2.CONV_DTYPE`` set to
float32) the port's teacher-forced ``forward`` and its prefill and
decode agree with it to 1e-5 of the largest logit (5e-7 to 8e-7
measured over 6 seeds: reassociated sums, and decode steps the SSD
recurrence where the reference scans chunks). In bf16, the served
dtype, the logits come out of layer outputs that largely cancel (the
embedded tokens start the stream at 0.02, ``models/hybrid_moe.py``),
and every product rounds its operands to 8 bits: 3 % to 12 % of the
largest logit over 6 seeds, so 25 % of it.
"""
import dataclasses
import importlib.util
import json
import pathlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.configs as configs
import repro_torch.models.transformer as tf
from repro_torch.configs.hybrid_moe import HybridMoEConfig
from repro_torch.inference.engine import Request, ServingEngine
from repro_torch.models import hybrid_moe, mamba2

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAME = "granite-4.0-h-small-ep8"
CFG = configs.get_config(NAME).tiny()
B, S, NEW = 2, 40, 5
SPANS = ("lm.prefill", "lm.decode", "lm.mamba", "lm.attn", "lm.moe")
COUNTERS = ("calls", "decode_steps", "tokens_routed", "held_rows")


def _reference():
    path = ROOT / "portbench" / "reference" / "granite4h.py"
    spec = importlib.util.spec_from_file_location("granite4h_reference",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()


def ref_config(cfg: HybridMoEConfig) -> dict:
    """The configuration file's keys, at ``cfg``'s sizes."""
    file = json.loads((ROOT / "portbench" / "configs"
                       / f"{NAME}.json").read_text())
    return {**file, "hidden_size": cfg.d_model,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads,
            "mamba_n_heads": cfg.ssm_heads, "mamba_d_head": cfg.ssm_d_head,
            "mamba_d_state": cfg.ssm_state,
            "mamba_chunk_size": cfg.ssm_chunk,
            "layer_types": list(cfg.layer_types),
            "attention_multiplier": cfg.attention_multiplier,
            "num_experts_per_tok": cfg.top_k,
            "first_held_expert": cfg.first_expert}


@pytest.fixture(autouse=True, scope="module")
def _evaluate_only():
    with torch.no_grad():
        yield


def all_float32(monkeypatch):
    monkeypatch.setattr(tf, "COMPUTE_DTYPE", torch.float32)
    monkeypatch.setattr(tf, "CACHE_DTYPE", torch.float32)
    monkeypatch.setattr(mamba2, "CONV_DTYPE", torch.float32)


@pytest.fixture
def float32(monkeypatch):
    all_float32(monkeypatch)


@pytest.fixture
def zeroed(monkeypatch):
    for name in COUNTERS:
        monkeypatch.setattr(hybrid_moe, name, 0)
    monkeypatch.setattr(hybrid_moe, "_held_on_device", [])
    monkeypatch.setattr(hybrid_moe, "ssd_scans", [])


def model(seed: int, cfg: HybridMoEConfig = CFG):
    return tf.init_params(cfg, torch.Generator().manual_seed(seed),
                          device="cpu")


def prompts(seed: int, s: int = S) -> torch.Tensor:
    return torch.randint(0, CFG.vocab, (B, s),
                         generator=torch.Generator().manual_seed(seed + 100))


def weights(m) -> dict:
    return {n: p.detach() for n, p in m.named_parameters()}


def served_logits(m, toks, new=NEW) -> tuple:
    """Greedy prefill and ``new`` decode steps through the cache: the
    logits of each step (B, new + 1, V) and the tokens fed back."""
    logits, cache, n = tf.prefill(CFG, m, {"tokens": toks}, S + new + 1)
    out, fed = [logits], []
    cache_len = torch.full((B,), n)
    for _ in range(new):
        nxt = logits.argmax(-1)
        fed.append(nxt)
        logits, cache = tf.decode_step(CFG, m, cache, nxt[:, None],
                                       cache_len)
        cache_len = cache_len + 1
        out.append(logits)
    return torch.stack(out, 1), torch.stack(fed, 1)


def reference_logits(m, feed, first, cfg=CFG) -> torch.Tensor:
    w = weights(m)
    return torch.cat([REF.logits(ref_config(cfg), w, feed[i:i + 1], first)
                      for i in range(feed.shape[0])])


# ------------------------------------------------------------------ registry
def test_registry_resolves_the_port_only_name():
    from repro.configs import ARCHS as REF_ARCHS
    cfg = configs.get_config(NAME)
    assert NAME not in configs.ARCHS and NAME in configs.PORT_ARCHS
    assert list(configs.ARCHS) == list(REF_ARCHS)
    assert tf.FAMILIES == ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
    assert cfg.family == "hybrid_moe" and cfg.family not in tf.FAMILIES
    assert (cfg.n_layers, cfg.d_model, cfg.vocab, cfg.n_experts,
            cfg.n_router_experts, cfg.top_k) == (40, 4096, 100352, 9, 72, 10)
    assert cfg.layer_types.count("attention") == 4
    assert 8.4e9 < cfg.param_count() < 8.45e9
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("granite-4.0-h-small")


def test_tiny_keeps_every_kind_and_a_held_share():
    assert set(CFG.layer_types) == {"mamba", "attention"}
    assert CFG.n_router_experts >= 8 and CFG.n_experts < CFG.n_router_experts
    assert sum(p.numel() for p in model(0).parameters()) == CFG.param_count()


@pytest.mark.parametrize("bad", [
    {"layer_types": ("mamba",)}, {"layer_types": ("mamba",) * 3 + ("mlp",)},
    {"first_expert": 15}])
def test_config_refuses_what_it_cannot_build(bad):
    with pytest.raises(ValueError):
        dataclasses.replace(CFG, **bad)


# --------------------------------------------------- port against reference
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_is_the_reference_in_float32(seed, float32):
    m, toks = model(seed), prompts(seed)
    ours = tf.forward(CFG, m, {"tokens": toks})
    ref = reference_logits(m, toks, 0)
    assert (ours - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_is_the_references_forward(seed, dtype,
                                                       monkeypatch):
    if dtype == "float32":
        all_float32(monkeypatch)
    m, toks = model(seed), prompts(seed)
    ours, fed = served_logits(m, toks)
    ref = reference_logits(m, torch.cat([toks, fed], 1), S - 1)
    tol = 1e-5 if dtype == "float32" else 0.25
    assert (ours - ref).abs().max() <= tol * ref.abs().max()


def test_serving_engine_serves_the_family():
    m, toks = model(3), prompts(3)
    engine = ServingEngine(CFG, m, max_len=S + NEW)
    out = engine.generate([Request(prompt=r, max_new_tokens=NEW)
                           for r in toks.tolist()])
    _, fed = served_logits(m, toks)
    assert out == fed.tolist()
    assert engine.timings["steps"] == NEW


def test_cache_holds_both_kinds_in_layer_order():
    cache = tf.init_cache(CFG, B, 64, device="cpu")
    n_attn = CFG.layer_types.count("attention")
    assert cache["k"].shape == (n_attn, B, 64, CFG.n_kv_heads, CFG.d_head)
    assert cache["ssm"].shape[:2] == (CFG.n_layers - n_attn, B)
    assert cache["conv"].shape[:2] == (CFG.n_layers - n_attn, B)


# ----------------------------------------------------------- the expert cut
def uncut_and_shares():
    """The tiny MoE layer uncut (all 16 experts held) and as 8 cards'
    shares of 2 experts each, every share the uncut layer's router and
    its own slice of the experts."""
    whole = dataclasses.replace(CFG, n_experts=CFG.n_router_experts)
    full = hybrid_moe.HeldMoE(whole, torch.Generator().manual_seed(7), "cpu")
    shares = []
    for first in range(0, CFG.n_router_experts, CFG.n_experts):
        part = hybrid_moe.HeldMoE(dataclasses.replace(
            CFG, first_expert=first), None, "cpu")
        part.router.copy_(full.router)
        for name in ("wi", "wg", "wo"):
            getattr(part, name).copy_(
                getattr(full, name)[first:first + CFG.n_experts])
        shares.append(part)
    return whole, full, shares


@pytest.mark.parametrize("per_token", [False, True],
                         ids=["prefill_form", "decode_form"])
def test_the_shares_add_up_to_the_uncut_layer(per_token, float32):
    """What the 8 shares give, with the shared expert counted once, is
    the uncut reference layer."""
    whole, full, shares = uncut_and_shares()
    shared = hybrid_moe.MLP(CFG, CFG.d_model, CFG.d_ff_shared,
                            torch.Generator().manual_seed(8), "cpu")
    z = torch.randn((B, S, CFG.d_model),
                    generator=torch.Generator().manual_seed(9))
    ours = sum(part(z, per_token) for part in shares) + shared(z)
    w = {f"x.moe.{n}": p.detach() for n, p in full.named_parameters()}
    w.update({f"x.shared.{n}": p.detach()
              for n, p in shared.named_parameters()})
    cfg = ref_config(whole)
    ref = torch.stack([
        REF._moe(cfg, w, "x.moe.", z[i]) + REF._swiglu(
            z[i], w["x.shared.wg"], w["x.shared.wi"], w["x.shared.wo"])
        for i in range(B)])
    assert (ours - ref).abs().max() <= 1e-5 * ref.abs().max()
    # a share alone is the reference with that share held
    part = shares[3]
    cfg = {**ref_config(CFG), "first_held_expert": part.cfg.first_expert}
    wp = {f"x.{n}": p.detach() for n, p in part.named_parameters()}
    alone = torch.stack([REF._moe(cfg, wp, "x.", z[i]) for i in range(B)])
    assert (part(z, per_token) - alone).abs().max() \
        <= 1e-5 * alone.abs().max()


@pytest.mark.parametrize("seed", [0, 1])
def test_no_routed_token_is_dropped(seed, float32, zeroed):
    """Every (token, choice) routed to a held expert is a row of its
    group: the held rows counted while traced are the routed pairs, and
    the prefill's grouped form equals decode's form, which weighs every
    token by its routing."""
    moe = hybrid_moe.HeldMoE(CFG, torch.Generator().manual_seed(seed), "cpu")
    # a skewed input: most tokens route to the same few experts
    z = torch.randn((1, 64, CFG.d_model),
                    generator=torch.Generator().manual_seed(seed + 20))
    z = z + 3.0 * moe.router[:, :3].sum(-1)
    _, _, held = moe.route(z.reshape(-1, CFG.d_model))
    with profile(activities=[ProfilerActivity.CPU]):
        grouped = moe(z)
    assert hybrid_moe.held_rows == int(held.sum()) > 0
    assert hybrid_moe.tokens_routed == 64
    assert (grouped - moe(z, True)).abs().max() <= 1e-5 * grouped.abs().max()


# ------------------------------------------------------- spans and counters
def test_untraced_opens_no_span_and_counts_nothing(zeroed, monkeypatch):
    def refuse(name):
        raise AssertionError(f"a span {name!r} opened untraced")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    served_logits(model(0), prompts(0))
    assert {n: getattr(hybrid_moe, n) for n in COUNTERS} == dict.fromkeys(
        COUNTERS, 0)
    assert hybrid_moe._held_on_device == [] and hybrid_moe.ssd_scans == []


def test_untraced_runs_the_same_operations(zeroed):
    """The operations of an untraced prefill and decode are those of a
    traced one less the counting of decode's held rows (a sum a
    layer)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    m, toks = model(0), prompts(0)
    with Ops() as plain:
        served_logits(m, toks)
    with profile(activities=[ProfilerActivity.CPU]), Ops() as traced:
        served_logits(m, toks)
    extra = list(traced.ops)
    for op in plain.ops:
        extra.remove(op)
    assert extra == ["aten.sum.default"] * (NEW * CFG.n_layers)


def test_traced_spans_nest_and_counters_recount(zeroed):
    m, toks = model(1), prompts(1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        served_logits(m, toks)
    spans = sorted(((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events() if e.name in SPANS),
                   key=lambda x: (x[0], -x[1]))
    names = [n for _, _, n in spans]
    assert names.count("lm.prefill") == 1
    assert names.count("lm.decode") == NEW
    per_call = 1 + NEW
    n_attn = CFG.layer_types.count("attention")
    assert names.count("lm.attn") == per_call * n_attn
    assert names.count("lm.mamba") == per_call * (CFG.n_layers - n_attn)
    assert names.count("lm.moe") == per_call * CFG.n_layers
    outer = [(s, e) for s, e, n in spans if n in ("lm.prefill", "lm.decode")]
    assert all(any(a <= s and e <= b for a, b in outer)
               for s, e, n in spans if n not in ("lm.prefill", "lm.decode"))
    c = hybrid_moe.counters()
    assert (c["calls"], c["decode_steps"]) == (1, NEW)
    assert c["tokens_routed"] == CFG.n_layers * B * (S + NEW)
    assert c["ssd_scans"] == [(B * CFG.ssm_heads, 48, CFG.ssm_d_head,
                               CFG.ssm_state, CFG.ssm_chunk)] * (
        CFG.n_layers - n_attn)
    # the held rows again, from the routing of the same run
    rows = 0
    for blk in m.layers:
        def hook(mod, args, out):
            nonlocal rows
            rows += int(mod.route(args[0].reshape(-1, CFG.d_model))[2].sum())
        blk.moe.register_forward_hook(hook)
    served_logits(m, toks)
    assert c["held_rows"] == rows
