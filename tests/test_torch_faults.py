"""The port's own faults against the reference, each held where it was
repaired, on the CPU.

* Microbatches on a sharded batch (``training/train_step.py`` ``_split``):
  four ``gloo`` ranks on a (2, 2) mesh under the ``dp`` layout hold one
  row each of a 4-row batch; microbatches 2 take the reference's global
  rows. Loss and gradients against the plain step (float32, 1e-5
  relative) and against the reference's ``make_train_step`` at
  microbatches 2 on the same weights (float32: the loss within 1e-5
  relative, each leaf's gradient within a relative Frobenius error of
  ``REF_GRAD_TOL``). Where a layout's batch axes do not divide the rows,
  the train step pads them to a multiple of the ranks, as GSPMD pads
  them (``_global_rows``), and each rank computes its own row: a
  (2, 4, 4) fake world under ``dp``, at microbatch 1 and at
  microbatches 2 of 20 rows, against XLA.
* 2d_seq's residual add (``distribution/annotate.py`` ``residual``): in
  the same run, every sublayer output's pin in the forward is one
  reduce-scatter and no all-reduce, and the loss and gradients equal the
  unsharded calls' (1e-5 relative).
* Gradients at the rank-by-rank call sites (``summed_map``): in the same
  run, the ``FAMILIES`` under 2d against the unsharded calls
  (``FAMILY_GRAD_TOL``): gemma3-1b, zamba2-1.2b and qwen3-moe-235b-a22b,
  then q heads the model axis does not divide (``project_heads``; one
  case leaves a rank no head), the MoE combine's all-to-all, the loss's
  logsumexp on the vocab shard and the embedding looked up on the
  table's shard, also on the multi-pod axes; and the loss's chunks
  recompute in the backward on another thread (as the card's autograd
  does) under the forward's annotation mesh.
* The dry run's FLOPs and peak memory (``launch/dryrun.py``, the
  products' weights gathered as GSPMD gathers them, ``gathered``): small
  probes (one layer, trip count 1, as ``tests/test_roofline.py``) traced
  on a fake world, a (2, 2) or (2, 8) ("data", "model") mesh, against
  the reference's ``lower_cell`` compiled in a subprocess on as many
  forced host devices: FLOPs within 25 % of XLA's ``cost_analysis()``,
  the peak a rank within a factor of ``PEAK_FACTOR`` = 2 of
  ``memory_analysis()`` (argument + output + temp - alias), and on the
  MoE's probe an all-to-all where XLA's HLO has one. The (2, 8) probes
  (``MESH_PROBES``) hold heads the model axis does not divide, a
  262,144-token vocab's logits and the MoE's combine. Both packages
  compute in float32 here: on the CPU XLA converts a bf16 product's
  operands to float32 and counts each conversion, which no device of
  the port's does. Phase 12's decode cells cut to one layer on the
  256-rank mesh: FLOPs within 25 % of XLA's, the peak at most
  ``PEAK_FACTOR`` times XLA's. A train cell's peak a rank on 8 ranks,
  (4, 2), is at most ``FSDP_PEAK_SHARE`` of its peak on 4, (2, 2), at
  the same global batch.
* The port's examples (``examples/torch_*.py``) run on the CPU when asked
  (``--device cpu``), each in a subprocess under 120 s.

``python tests/test_torch_faults.py`` (``PYTHONPATH=src``) prints each
probe's and decode cell's counts beside XLA's.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh

import _torch_faults_worker
import repro.configs as ref_configs
import repro.models.layers as ref_layers
import repro.models.transformer as ref_tf
from repro.training import optimizer as ref_opt
from repro.training import train_step as ref_ts
import repro_torch.models.layers as layers
import repro_torch.models.transformer as tf
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch import dryrun, mesh as meshes
from repro_torch.models.weights import to_reference

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
ARCH, LAYERS, ROWS, SEQ = "olmo-1b", 2, 4, 16   # tokens (ROWS, SEQ + 1)
REF_GRAD_TOL = 1e-5
# case -> (arch, layers, config overrides) held sharded against unsharded
# under 2d on the (2, 2) mesh: gemma3's one kv head beside sharded q
# heads, zamba2's Mamba layers (causal conv, scan) and shared block,
# qwen3-moe's router, dispatch and the combine's all-to-all; then q heads
# the 2 model ranks do not divide (``project_heads``): 3 heads of
# whisper's (kv heads alike, and the cross-attention's), of qwen2-vl's
# over 1 kv head held whole, of qwen3-moe's over 1 kv head, and gemma3's
# one head, which leaves the second model rank none. Each loss takes its
# logsumexp on the 512-token vocab's shard and looks its tokens up on the
# table's shard
FAMILIES = {
    "gemma3-1b": ("gemma3-1b", 2, {}),
    "zamba2-1.2b": ("zamba2-1.2b", 3, {}),
    "qwen3-moe-235b-a22b": ("qwen3-moe-235b-a22b", 2, {}),
    "whisper-small-3-heads": ("whisper-small", 2,
                              {"n_heads": 3, "n_kv_heads": 3}),
    "qwen2-vl-2b-3-heads": ("qwen2-vl-2b", 2,
                            {"n_heads": 3, "n_kv_heads": 1}),
    "qwen3-moe-3-heads": ("qwen3-moe-235b-a22b", 2,
                          {"n_heads": 3, "n_kv_heads": 1}),
    "gemma3-1b-1-head": ("gemma3-1b", 2, {"n_heads": 1, "n_kv_heads": 1}),
    # the multi-pod axes on (2, 2, 1): the table's width on ("pod",
    # "data"), whose rows go back by two all-to-alls, nested as GSPMD's
    "olmo-1b-pods": ("olmo-1b", 2, {},
                     ((2, 2, 1), ("pod", "data", "model"))),
}
FAMILY_GRAD_TOL = 3e-5
PEAK_FACTOR = 2.0
FSDP_PEAK_SHARE = 0.6


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(value, np.float64)
    return out


def _rel(ours, ref) -> float:
    return float(np.linalg.norm(ours - ref) / max(np.linalg.norm(ref), 1e-30))


# ---------------------------------------------- four gloo ranks, one run
@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """The workers' results, the reference weights and the tokens."""
    tmp = tmp_path_factory.mktemp("faults")
    ref_cfg = dataclasses.replace(ref_configs.get_config(ARCH).tiny(),
                                  n_layers=LAYERS)
    tree = jax.tree.map(np.asarray, jax.jit(
        ref_tf.init_params, static_argnums=0)(ref_cfg,
                                              jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(7).integers(
        0, ref_cfg.vocab, (ROWS, SEQ + 1)).astype(np.int32)
    torch.save({"arch": ARCH, "layers": LAYERS, "tree": tree,
                "tokens": tokens, "families": FAMILIES}, tmp / "in.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_torch_faults_worker.run,
                         args=(r, WORLD, str(tmp / "store"),
                               str(tmp / "in.pt"), str(tmp / "out.pt")))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    assert all(not p.is_alive() for p in procs)
    assert [p.exitcode for p in procs] == [0] * WORLD
    return torch.load(tmp / "out.pt", weights_only=False), tree, tokens


def _port_flat(grads: dict) -> dict:
    cfg = dataclasses.replace(get_config(ARCH).tiny(), n_layers=LAYERS)
    return _flat(to_reference(cfg, {k: torch.as_tensor(v)
                                    for k, v in grads.items()}))


def test_sharded_microbatches_equal_the_plain_step(gloo_run):
    """A rank's one row does not split into 2 microbatches: they take the
    global rows, and the step's loss and gradients are the plain
    step's."""
    out, _, _ = gloo_run
    (loss, grads), (mb_loss, mb_grads) = out["plain"], out["microbatches"]
    assert mb_loss == pytest.approx(loss, rel=1e-5)
    assert grads.keys() == mb_grads.keys()
    errs = {k: _rel(mb_grads[k].astype(np.float64), grads[k]) for k in grads}
    assert max(errs.values()) <= 1e-5, max(errs.items(), key=lambda kv: kv[1])


def test_sharded_microbatches_equal_the_references(gloo_run, monkeypatch):
    """The same step against the reference's ``make_train_step`` at
    microbatches 2 (its ``_split_batch`` and scan) on the same weights,
    both in float32; the reference's gradients caught on their way to
    its AdamW."""
    out, tree, tokens = gloo_run
    monkeypatch.setattr(ref_tf, "COMPUTE_DTYPE", jax.numpy.float32)
    monkeypatch.setattr(ref_layers, "COMPUTE_DTYPE", jax.numpy.float32)
    ref_cfg = dataclasses.replace(ref_configs.get_config(ARCH).tiny(),
                                  n_layers=LAYERS)
    opt_cfg = ref_opt.OptimizerConfig(total_steps=10)
    caught = {}
    update = ref_ts.adamw_update

    def spy(cfg_, params, grads, opt_state):
        caught["grads"] = grads
        return update(cfg_, params, grads, opt_state)

    monkeypatch.setattr(ref_ts, "adamw_update", spy)
    params = jax.tree.map(jax.numpy.asarray, tree)
    step = ref_ts.make_train_step(ref_cfg, opt_cfg, ref_ts.TrainConfig(
        microbatches=2, remat="none"))
    _, metrics = step({"params": params,
                       "opt": ref_opt.init_opt_state(opt_cfg, params)},
                      {"tokens": jax.numpy.asarray(tokens)})
    mb_loss, mb_grads = out["microbatches"]
    assert mb_loss == pytest.approx(float(metrics["loss"]), rel=1e-5)
    ours = _port_flat(mb_grads)
    ref = _flat(jax.tree.map(np.asarray, caught["grads"]))
    assert ours.keys() == ref.keys()
    errs = {k: _rel(ours[k], ref[k]) for k in ref}
    assert max(errs.values()) <= REF_GRAD_TOL, max(errs.items(),
                                                   key=lambda kv: kv[1])


def test_2d_seq_residual_adds_reduce_scatter(gloo_run):
    """Under 2d_seq each sublayer output reaches its residual add by one
    reduce-scatter into the stream's sequence shard (no all-reduce), two
    a layer; the loss and gradients equal the unsharded calls'."""
    out, _, _ = gloo_run
    (loss, grads), (s_loss, s_grads), pins = out["seq"]
    assert len(pins) == 2 * LAYERS
    for pin in pins:
        assert pin == {"reduce_scatter_tensor": 1}, pin
    assert s_loss == pytest.approx(loss, rel=1e-5)
    errs = {k: _rel(s_grads[k].astype(np.float64), grads[k]) for k in grads}
    assert max(errs.values()) <= 1e-5, max(errs.items(), key=lambda kv: kv[1])


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_sharded_gradients_equal_the_unsharded(gloo_run, name):
    """Under 2d on the (2, 2) mesh every leaf's gradient equals the
    unsharded one (relative Frobenius error ``FAMILY_GRAD_TOL``, float32:
    the ranks' shares add in another order; a Mamba layer's ``A_log``
    sums the most terms). A replicated input of a call site run rank by
    rank gets each rank's share and those shares are added
    (``summed_map``); taken as the replicated whole, they left gemma3's
    kv projections, zamba2's Mamba parameters and the tied embedding
    far off. The cases with 3 heads or 1 on the 2 model ranks run the
    heads' uneven shards (an empty one for gemma3's one head)."""
    out, _, _ = gloo_run
    (loss, grads), (s_loss, s_grads) = out["families"][name]
    assert s_loss == pytest.approx(loss, rel=1e-5)
    assert grads.keys() == s_grads.keys()
    errs = {k: _rel(s_grads[k].astype(np.float64), grads[k]) for k in grads}
    assert max(errs.values()) <= FAMILY_GRAD_TOL, max(
        errs.items(), key=lambda kv: kv[1])


# ------------------------------------------------- the dry run's probes
XLA_PROBE = textwrap.dedent("""
    import dataclasses, json, math, os, sys
    arch, kind, seq, batch, over, dims, *extra = json.loads(sys.argv[1])
    axes, kw = extra or (["data", "model"], {})
    os.environ["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                               f"{math.prod(dims)}")
    import jax.numpy as jnp
    import repro.models.layers as L, repro.models.transformer as T
    from repro.configs import ShapeConfig, get_config
    from repro.launch.dryrun import cost_analysis_dict, lower_cell
    from repro.launch.mesh import _make_mesh
    from repro.roofline.analysis import parse_collectives
    T.COMPUTE_DTYPE = L.COMPUTE_DTYPE = jnp.float32
    cfg = dataclasses.replace(get_config(arch), name="probe", n_layers=1,
                              **over)
    shape = ShapeConfig("probe", seq_len=seq, global_batch=batch, kind=kind)
    mesh = _make_mesh(tuple(dims), tuple(axes))
    compiled = lower_cell(cfg, shape, mesh, remat="full", **kw).compile()
    m = compiled.memory_analysis()
    coll = parse_collectives(compiled.as_text(), math.prod(dims))
    print(json.dumps({
        "flops": float(cost_analysis_dict(compiled)["flops"]),
        "peak": m.argument_size_in_bytes + m.output_size_in_bytes
        + m.temp_size_in_bytes - m.alias_size_in_bytes,
        "collectives": coll.counts}))
""")

# (arch, kind, seq_len, global batch, config overrides): one SSM decode
# whose vocab the model axis does not divide (its unembedding is split
# over the axis by its contraction), one GQA decode whose one kv head the
# model axis does not divide (its head dim is sharded instead), one train
# cell
PROBES = {
    "mamba2-decode": ("mamba2-130m", "decode", 256, 8, {"vocab": 50281}),
    "gemma3-decode": ("gemma3-1b", "decode", 1024, 8, {"vocab": 4096}),
    "olmo-train": ("olmo-1b", "train", 512, 4, {"vocab": 4096}),
}


@pytest.fixture
def world():
    def start(n):
        meshes.init_fake_world(n)
    yield start
    meshes.destroy_world()


def _xla(probe, dims, axes=("data", "model"), **kw) -> dict:
    """XLA's cost and memory analyses of ``probe`` compiled by the
    reference on ``dims`` forced host devices named ``axes``, with
    ``lower_cell``'s keywords ``kw``, in a subprocess."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": str(ROOT / "src")}
    got = subprocess.run([sys.executable, "-c", XLA_PROBE,
                          json.dumps([*probe, list(dims), list(axes), kw])],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert got.returncode == 0, got.stderr[-3000:]
    return json.loads(got.stdout.strip().splitlines()[-1])


def _traced(probe, dims, monkeypatch, axes=("data", "model"), **kw):
    """The port's ``Traced`` record of ``probe`` on a mesh of ``dims``
    named ``axes`` (a fake world at least that large), with
    ``lower_cell``'s keywords ``kw``."""
    arch, kind, seq, batch, over = probe
    monkeypatch.setattr(tf, "COMPUTE_DTYPE", torch.float32)
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)
    cfg = dataclasses.replace(get_config(arch), name="probe", n_layers=1,
                              **over)
    shape = ShapeConfig("probe", seq_len=seq, global_batch=batch, kind=kind)
    mesh = init_device_mesh("cpu", dims, mesh_dim_names=axes)
    return dryrun.lower_cell(cfg, shape, mesh, remat="full", **kw)


@pytest.mark.parametrize("name", sorted(PROBES))
def test_dry_run_probe_matches_xla(name, world, monkeypatch):
    """The counted FLOPs a rank within 25 % of XLA's and the peak a rank
    within a factor of 2 of its memory analysis, on the same probe."""
    world(4)
    probe = PROBES[name]
    ours = _traced(probe, (2, 2), monkeypatch)
    xla = _xla(probe, (2, 2))
    assert ours.flops == pytest.approx(xla["flops"], rel=0.25)
    ratio = ours.memory["peak"] / xla["peak"]
    assert 1 / PEAK_FACTOR <= ratio <= PEAK_FACTOR, (ours.memory, xla)


# one-layer probes on a (2, 8) ("data", "model") mesh, where 8 divides
# neither whisper-small's nor qwen2-vl-2b's 12 heads nor gemma3-1b's 4
# (``project_heads``: whole heads a rank, unevenly; every rank ran every
# head, 2.6x XLA's FLOPs on whisper's probe); gemma3-1b train with its
# own 262,144-token vocab, whose logits set the peak (the logsumexp on
# each rank's vocab shard; DTensor's gathered the logits whole, 3.1x
# XLA's peak); and qwen3-moe train, whose expert outputs go back to their
# rows by an all-to-all as XLA's do (``models/mlp.py``)
MESH_PROBES = {
    "whisper-heads": ("whisper-small", "train", 256, 4,
                      {"vocab": 4096, "n_encoder_layers": 1}),
    "qwen2-vl-heads": ("qwen2-vl-2b", "prefill", 512, 4, {"vocab": 4096}),
    "gemma3-heads": ("gemma3-1b", "train", 512, 4, {"vocab": 4096}),
    "gemma3-vocab": ("gemma3-1b", "train", 512, 4, {}),
    "qwen3-moe-train": ("qwen3-moe-235b-a22b", "train", 128, 16,
                        {"vocab": 4096}),
}
MESH_PROBE_DIMS = (2, 8)
# the port's collectives (``CommRecorder``) by XLA's names
COMM_TYPES = {"all_gather_into_tensor": "all-gather",
              "all_reduce": "all-reduce",
              "reduce_scatter_tensor": "reduce-scatter",
              "all_to_all_single": "all-to-all"}


def _comm_types(traced) -> set:
    return {COMM_TYPES.get(str(k).split(".")[-1], str(k))
            for k in traced.comm.get_comm_counts()}


@pytest.mark.parametrize("name", sorted(MESH_PROBES))
def test_mesh_probe_matches_xla(name, world, monkeypatch):
    """On the (2, 8) mesh: the counted FLOPs a rank within 25 % of XLA's,
    the peak a rank within ``PEAK_FACTOR`` of its memory analysis, and
    where XLA's program moves data by an all-to-all (the MoE's experts
    back to their rows), the port's does too."""
    world(16)
    probe = MESH_PROBES[name]
    ours = _traced(probe, MESH_PROBE_DIMS, monkeypatch)
    xla = _xla(probe, MESH_PROBE_DIMS)
    assert ours.flops == pytest.approx(xla["flops"], rel=0.25)
    ratio = ours.memory["peak"] / xla["peak"]
    assert 1 / PEAK_FACTOR <= ratio <= PEAK_FACTOR, (ours.memory, xla)
    if name == "qwen3-moe-train":
        assert "all-to-all" in xla["collectives"], xla["collectives"]
        assert "all-to-all" in _comm_types(ours), _comm_types(ours)


# phase 12's decode cells at their published shapes and widths, cut to
# one layer, on the 256-rank production mesh (16 x 16)
DECODE_CELLS = {
    "mamba2-130m": ("mamba2-130m", "decode", 32768, 128, {}),
    "qwen3-moe-235b-a22b": ("qwen3-moe-235b-a22b", "decode", 32768, 128,
                            {}),
    "gemma3-1b-long_500k": ("gemma3-1b", "decode", 524288, 1, {}),
}


@pytest.mark.parametrize("name", sorted(DECODE_CELLS))
def test_decode_cell_flops_match_xla_on_the_production_mesh(
        name, world, monkeypatch):
    """Counted FLOPs a rank within 25 % of XLA's on a decode cell of
    phase 12 cut to one layer, on 256 ranks: what the cell computes
    beyond ``analytic_cost`` (mamba2's input projection and vocab, which
    16 does not divide; qwen3-moe's capacity slots; gemma3's one row on
    every data rank) XLA computes too. The peak a rank is at most
    ``PEAK_FACTOR`` times XLA's: the embedding's rows are looked up on the
    table's shard and the unembedding splits its contraction over the
    table's FSDP shard, as XLA's do (gathering the table put mamba2-130m
    at 5.5x XLA's). It may lie below: XLA holds qwen3-moe's gathered
    expert weights and their casts at once, the port one at a time."""
    world(256)
    probe = DECODE_CELLS[name]
    ours = _traced(probe, (16, 16), monkeypatch)
    xla = _xla(probe, (16, 16))
    assert ours.flops == pytest.approx(xla["flops"], rel=0.25)
    assert ours.memory["peak"] <= PEAK_FACTOR * xla["peak"], (ours.memory,
                                                             xla)


def test_train_peak_falls_with_more_fsdp_ranks(world, monkeypatch):
    """olmo-1b cut to 2 layers, 8 x 512 tokens: the peak a rank on 8
    ranks (4 data x 2 model) is at most ``FSDP_PEAK_SHARE`` of that on 4
    (2 x 2), the same global batch and FSDP rules: the parameters,
    moments and each rank's rows all halve with the data axis, only
    small replicated leaves do not (products contracting over the FSDP
    shard with the batch replicated kept it above the share)."""
    world(8)
    probe = ("olmo-1b", "train", 512, 8, {"vocab": 4096, "n_layers": 2})
    arch, kind, seq, batch, over = probe
    peaks = []
    for dims in ((2, 2), (4, 2)):
        cfg = dataclasses.replace(get_config(arch), name="probe", **over)
        shape = ShapeConfig("probe", seq_len=seq, global_batch=batch,
                            kind=kind)
        mesh = init_device_mesh("cpu", dims,
                                mesh_dim_names=("data", "model"))
        peaks.append(dryrun.lower_cell(cfg, shape, mesh).memory["peak"])
    assert peaks[1] <= FSDP_PEAK_SHARE * peaks[0], peaks


# a train batch whose rows the dp layout's 32 ranks do not divide: 16 rows
# on a (2, 4, 4) mesh, one a rank on ("data", "model") as batch_shardings
# lays them out; and 40 rows at microbatches 2, 20 a microbatch, which no
# product of whole mesh axes divides beyond 4 (5 rows a rank)
DP_PROBE = ("olmo-1b", "train", 128, 16, {"vocab": 4096})
DP_MICRO_PROBE = ("olmo-1b", "train", 128, 40, {"vocab": 4096})
DP_MESH = ((2, 4, 4), ("pod", "data", "model"))
DP_PEAK_GROWTH = 1.25


def test_dp_rows_too_few_for_the_ranks_stay_on_their_ranks(world,
                                                           monkeypatch):
    """Under ``dp``, where the layout's batch axes do not divide the rows,
    the train step pads them to a multiple of the 32 ranks, as GSPMD pads
    them (``_global_rows``), and each rank computes its own row, not
    every row: at microbatch 1 (16 rows) the FLOPs a rank within 25 % of
    XLA's and the peak within ``PEAK_FACTOR`` of its memory analysis
    (every rank computing all 16 rows fails it); at microbatches 2 of 20
    rows, which whole mesh axes split at most 4 ways (5 rows a rank),
    within 25 % of twice XLA's (XLA counts the microbatch scan's body
    once), at a peak at most ``DP_PEAK_GROWTH`` times microbatch 1's (the
    parameters and moments dominate; one row's activations live at a
    time). XLA splits such batches below a whole row a rank (its count
    is 0.65 to 1.5 rows' worth for 12 to 28 rows a microbatch on these
    ranks), which whole rows cannot follow."""
    world(32)
    dims, axes = DP_MESH
    one = _traced(DP_PROBE, dims, monkeypatch, axes, layout="dp")
    two = _traced(DP_MICRO_PROBE, dims, monkeypatch, axes, layout="dp",
                  microbatches=2)
    xla = _xla(DP_PROBE, dims, axes, layout="dp")
    xla_two = _xla(DP_MICRO_PROBE, dims, axes, layout="dp", microbatches=2)
    assert one.flops == pytest.approx(xla["flops"], rel=0.25)
    ratio = one.memory["peak"] / xla["peak"]
    assert 1 / PEAK_FACTOR <= ratio <= PEAK_FACTOR, (one.memory, xla)
    assert two.flops == pytest.approx(2 * xla_two["flops"], rel=0.25)
    assert two.memory["peak"] <= DP_PEAK_GROWTH * one.memory["peak"], (
        two.memory, one.memory)


@pytest.mark.parametrize("layout", ["2d", "dp"])
def test_loss_chunk_recompute_on_another_thread_keeps_the_layout(
        world, layout):
    """The loss's chunks recompute their logits in the backward, which on
    the card runs on autograd's device thread, where the thread-local
    annotation mesh is not installed; the recompute must take the
    forward's path (the unembedding split over the model axis, whose
    513-token vocab it does not divide; the weights gathered on the
    layout's batch axes): a tiny train loss on a (2, 2) mesh, the
    backward run on a fresh thread."""
    import threading
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distribution.annotate import annotation_mesh
    from repro_torch.distribution.sharding import (batch_shardings,
                                                   distribute_model,
                                                   distribute_tree)
    from repro_torch.training.train_step import TrainConfig, make_loss_fn
    world(4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = dataclasses.replace(get_config("olmo-1b").tiny(), vocab=513)
    fake = FakeTensorMode()
    with annotation_mesh(mesh, layout), fake, implicit_replication():
        model = distribute_model(tf.init_params(cfg, device="cpu"), mesh)
        tokens = torch.zeros((4, 65), dtype=torch.int64)
        batch = distribute_tree({"tokens": tokens}, mesh, batch_shardings(
            mesh, {"tokens": tokens}, layout))
        loss = make_loss_fn(cfg, TrainConfig(remat="none"))(model, batch)
    errors, grads = [], []

    def backward():
        try:
            with fake, implicit_replication():
                grads.extend(torch.autograd.grad(loss,
                                                 list(model.parameters())))
        except Exception as e:  # reported by the assertion below
            errors.append(e)

    t = threading.Thread(target=backward)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    assert not errors, errors[0]
    assert len(grads) == len(list(model.parameters()))


# -------------------------------------------------------- the examples
@pytest.mark.parametrize("script,args", [
    ("torch_autotune_kernel.py", []),
    ("torch_serve_batch.py", []),
    ("torch_train_lm.py", ["--steps", "4"]),
])
def test_example_runs_on_the_cpu_when_asked(script, args, tmp_path):
    """The example ends with exit 0 on the CPU, having imported nothing of
    jax or of the reference."""
    path = ROOT / "examples" / script
    run = ("import runpy, sys; sys.argv = sys.argv[1:]; "
           "runpy.run_path(sys.argv[0], run_name='__main__'); "
           "bad = [m for m in sys.modules if m.split('.')[0] in "
           "('jax', 'repro')]; assert not bad, bad")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "TMPDIR": str(tmp_path)}
    got = subprocess.run([sys.executable, "-c", run, str(path), "--device",
                          "cpu", *args], capture_output=True, text=True,
                         env=env, cwd=tmp_path, timeout=120)
    assert got.returncode == 0, got.stdout[-2000:] + got.stderr[-3000:]


def main() -> None:
    """``python tests/test_torch_faults.py``: the port's counted FLOPs,
    peak a rank and collective types beside XLA's, for each probe on the
    (2, 2) and (2, 8) meshes and each decode cell on the (16, 16) one
    (``PYTHONPATH=src``)."""
    class Patch:
        def setattr(self, obj, name, value):
            setattr(obj, name, value)

    meshes.init_fake_world(256)
    for table, dims in ((PROBES, (2, 2)), (MESH_PROBES, MESH_PROBE_DIMS),
                        (DECODE_CELLS, (16, 16))):
        for name, probe in sorted(table.items()):
            ours, xla = _traced(probe, dims, Patch()), _xla(probe, dims)
            print(f"{name:22s} {dims}: flops {ours.flops:.4g} against "
                  f"XLA's {xla['flops']:.4g} ({ours.flops / xla['flops']:.3f}"
                  f"x); peak {ours.memory['peak']:,} against "
                  f"{xla['peak']:,} bytes "
                  f"({ours.memory['peak'] / xla['peak']:.3f}x); "
                  f"collectives {sorted(_comm_types(ours))} against "
                  f"{sorted(xla['collectives'])}", flush=True)
    meshes.destroy_world()


if __name__ == "__main__":
    main()
