"""The port's dry run, collectives, memory account and hillclimb.

Fake worlds of 1, 4 and 512 ranks (each destroyed at its test's end, so
an xdist worker stays clean), small configs only: the olmo probe of
``tests/test_roofline.py`` against ``analytic_cost`` and the reference's
XLA cost analysis; hand-counted all-reduce, all-gather and peak memory;
every family and kind traced on a (2, 2) mesh; ``run_cell``'s record in
the reference's keys; ``dist_space`` and ``hillclimb`` against the
reference's with a stubbed ``run_cell``.
"""
import dataclasses
import math

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Partial, Replicate, Shard, DTensor

from repro.autotune import perf as ref_perf
from repro.configs import get_config as ref_get_config
from repro.configs import ShapeConfig as RefShapeConfig
from repro_torch.autotune import perf
from repro_torch.configs import ARCHS, SHAPES, ShapeConfig, get_config
from repro_torch.launch import dryrun, mesh as meshes
from repro_torch.roofline.analysis import (CommRecorder, analytic_cost,
                                           collectives_from_comm)
from repro_torch.scenarios import facts_from_compiled


@pytest.fixture
def world():
    """``world(n)`` starts a fake world of n ranks; the test's end
    destroys it."""
    def start(n):
        meshes.init_fake_world(n)
    yield start
    meshes.destroy_world()


def _mesh22():
    return init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))


# ------------------------------------------------------------ the probe
def test_olmo_probe_flops_match_analytic_and_xla(world):
    """olmo-1b cut to one layer and a 4096 vocab, 4 × 512 tokens, remat
    none, on a one-rank fake world: the counted FLOPs lie within 25 % of
    ``analytic_cost`` and of the reference's XLA cost analysis."""
    import jax
    from repro.launch.dryrun import cost_analysis_dict as ref_cost
    from repro.launch.dryrun import lower_cell as ref_lower
    from repro.launch.mesh import make_host_mesh as ref_host_mesh
    world(1)
    cfg = dataclasses.replace(get_config("olmo-1b"), name="olmo-probe",
                              n_layers=1, vocab=4096)
    shape = ShapeConfig("probe", seq_len=512, global_batch=4, kind="train")
    traced = dryrun.lower_cell(cfg, shape, meshes.make_host_mesh("cpu"),
                               remat="none")
    ours = traced.flops
    analytic, _ = analytic_cost(cfg, shape, remat="none", n_chips=1)
    assert ours == pytest.approx(analytic, rel=0.25)
    ref_cfg = dataclasses.replace(ref_get_config("olmo-1b"),
                                  name="olmo-probe", n_layers=1, vocab=4096)
    ref_shape = RefShapeConfig("probe", seq_len=512, global_batch=4,
                               kind="train")
    compiled = ref_lower(ref_cfg, ref_shape, ref_host_mesh(),
                         remat="none").compile()
    xla = float(ref_cost(compiled)["flops"])
    assert ours == pytest.approx(xla, rel=0.25)
    facts = facts_from_compiled(traced)
    assert facts == {"flops": ours, "bytes accessed": traced.bytes_accessed}
    assert traced.bytes_accessed > 0 and traced.collectives().counts == {}
    assert jax.devices()  # the reference stayed on its host device


# ----------------------------------------------------------- collectives
def test_collectives_from_comm_hand_counted(world):
    """An all-reduce over the model axis and an all-gather over the data
    axis of a (2, 2) mesh, priced by the ring model by hand."""
    world(4)
    mesh = _mesh22()
    with FakeTensorMode():
        local = torch.zeros(64, 32)  # float32: 8192 bytes a rank
        part = DTensor.from_local(local, mesh, (Replicate(), Partial()),
                                  run_check=False)
        shard = DTensor.from_local(local, mesh, (Shard(0), Replicate()),
                                   run_check=False)
        with CommRecorder() as comm:
            part.redistribute(mesh, (Replicate(), Replicate()))
            shard.redistribute(mesh, (Replicate(), Replicate()))
    s = collectives_from_comm(comm, mesh)
    assert s.counts == {"all-reduce": 1, "all-gather": 1}
    n = 4  # ranks; groups of g = 2
    assert s.wire_bytes["all-reduce"] == pytest.approx(
        2 * (2 - 1) / 2 * 8192 * n)
    # the all-gather's payload is its gathered output, 128 × 32 floats
    assert s.wire_bytes["all-gather"] == pytest.approx(
        (2 - 1) / 2 * 16384 * n)
    assert s.total_wire_bytes == pytest.approx(sum(s.wire_bytes.values()))
    assert sum(comm.get_comm_counts().values()) == 2


def test_tracer_counts_peak_memory_by_hand():
    """Live storages: 4 KB argument, a 4 KB and an 8 KB temporary at once,
    then the 8 KB one freed: peak 16 KB; views add nothing."""
    with FakeTensorMode():
        a = torch.zeros(1024)                       # 4096 bytes
        tracer = dryrun._Tracer()
        with tracer:
            assert tracer.track([a]) == 4096
            b = a * 2                               # +4096
            c = torch.cat([b, b])                   # +8192 -> 16384
            v = c.view(2, 1024)                     # a view: +0
            del c, v
            d = b + 1                               # +4096 -> 12288
    assert tracer.peak == 16384
    assert tracer.live == 12288
    assert d.shape == (1024,)
    assert tracer.flops == 0 and tracer.n_ops == 4
    assert tracer.bytes == (4096 + 4096) + 2 * 4096 + 8192 + 2 * 4096


# --------------------------------------------------- every family, (2, 2)
# prefill and decode of every config; train of one config of each
# kind of block (dense, moe, hybrid, audio)
_TRACED = ([(a, k) for a in sorted(ARCHS) for k in ("prefill", "decode")]
           + [(a, "train") for a in ("olmo-1b", "qwen3-moe-235b-a22b",
                                     "zamba2-1.2b", "whisper-small")])


@pytest.mark.parametrize("arch,kind", _TRACED)
def test_every_family_and_kind_traces_on_a_2x2_mesh(world, arch, kind):
    """Tiny configs at 4 rows: the step traces through DTensor, the
    kernels' operators count their FLOPs, and the memory account holds
    (peak = argument + output + temp - alias, arguments live throughout)."""
    world(4)
    cfg = get_config(arch).tiny()
    shape = ShapeConfig("t", 64 if kind != "decode" else 128, 4, kind)
    tr = dryrun.lower_cell(cfg, shape, _mesh22())
    m = tr.memory
    assert tr.flops > 0 and tr.bytes_accessed > 0
    assert m["peak"] == m["argument"] + m["output"] + m["temp"] - m["alias"]
    assert m["peak"] >= m["argument"] > 0
    if kind != "prefill":  # a train step and decode update their state
        assert m["alias"] > 0
    assert sum(tr.collectives().counts.values()) > 0


def test_run_cell_writes_the_references_record(world, monkeypatch):
    """A cell on the 512-rank world (a tiny olmo in place of the published
    one): the reference's record keys, a roofline from ``analytic_cost``,
    and skipped cells as the reference skips them."""
    world(512)
    monkeypatch.setitem(dryrun.ARCHS, "olmo-1b", get_config("olmo-1b").tiny())
    rec = dryrun.run_cell("olmo-1b", "decode_32k", "multi", device="cpu")
    assert rec["status"] == "ok", rec.get("traceback")
    assert set(rec) >= {"arch", "shape", "mesh", "microbatches", "remat",
                        "layout", "status", "n_chips", "lower_s",
                        "compile_s", "memory", "cost", "collectives",
                        "roofline"}
    assert rec["n_chips"] == 512
    assert set(rec["memory"]) == {
        "argument_bytes_per_chip", "output_bytes_per_chip",
        "temp_bytes_per_chip", "alias_bytes_per_chip",
        "peak_bytes_per_chip"}
    assert set(rec["cost"]) == {"hlo_flops_per_chip", "hlo_bytes_per_chip",
                                "analytic_flops_per_chip",
                                "analytic_bytes_per_chip"}
    a_flops, _ = analytic_cost(dryrun.ARCHS["olmo-1b"], SHAPES["decode_32k"],
                               "full", 512)
    assert rec["cost"]["analytic_flops_per_chip"] == a_flops
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    skip = dryrun.run_cell("olmo-1b", "long_500k", "single", device="cpu")
    assert skip["status"] == "skipped"


def test_the_cli_exits_nonzero_when_a_cell_errors(world, monkeypatch,
                                                  tmp_path, capsys):
    def failing(*a, **kw):
        return {"status": "error", "error": "boom"}
    monkeypatch.setattr(dryrun, "run_cell", failing)
    monkeypatch.setattr(dryrun, "init_fake_world", lambda n: None)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "olmo-1b", "--shape", "train_4k", "--mesh",
                     "single", "--out", str(tmp_path), "--device", "cpu"])
    assert e.value.code == 1
    assert "1 errors" in capsys.readouterr().out


# --------------------------------------------------------- the hillclimb
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dist_space_matches_the_references(kind):
    ours, ref = perf.dist_space(kind), ref_perf.dist_space(kind)
    assert ours.name == ref.name
    assert [t.name for t in ours.tunables] == [t.name for t in ref.tunables]
    assert ours.valid_configs == ref.valid_configs
    assert [ours.config_id(c) for c in ours.valid_configs] == \
        [ref.config_id(c) for c in ref.valid_configs]


def _stub_run_cell(arch, shape, mesh_kind, *, microbatches=1, remat="full",
                   layout="2d", **kw):
    """A deterministic record: compute falls with microbatches, memory
    grows without remat; one config errors, one exceeds 16 GiB."""
    if layout == "dp" and remat == "dots":
        return {"status": "error", "error": "stub"}
    compute = 1.0 + {"none": 0.0, "dots": 0.3, "full": 0.5}[remat] \
        + 0.1 * {"2d": 0, "dp": 1, "2d_seq": 2}[layout]
    collective = 0.8 / microbatches + (0.4 if layout == "dp" else 0.0)
    peak = (20 if remat == "none" and microbatches == 1 else 8) * 2**30
    return {"status": "ok", "compile_s": 0.0,
            "memory": {"peak_bytes_per_chip": peak},
            "roofline": {"compute_s": compute, "memory_s": 0.5,
                         "collective_s": collective,
                         "dominant": "compute"}}


@pytest.mark.parametrize("strategy", ["greedy_ils", "random_search"])
def test_hillclimb_matches_the_reference_on_a_stubbed_cell(
        strategy, monkeypatch, tmp_path):
    import repro.launch.dryrun as ref_dryrun
    monkeypatch.setattr(dryrun, "run_cell", _stub_run_cell)
    monkeypatch.setattr(ref_dryrun, "run_cell", _stub_run_cell)
    ours = perf.hillclimb("olmo-1b", "train_4k", "single", strategy=strategy,
                          max_evals=8, out_dir=str(tmp_path / "port"),
                          hbm_budget=ref_perf.HBM_BUDGET)
    ref = ref_perf.hillclimb("olmo-1b", "train_4k", "single",
                             strategy=strategy, max_evals=8,
                             out_dir=str(tmp_path / "ref"))
    assert ours == ref
    assert ours["baseline"]["config"] == {"layout": "2d", "remat": "full",
                                          "microbatches": 1}
    assert math.isfinite(ours["best"]["objective_s"])
    assert ours["improvement"] >= 1.0
    assert any(e["status"] == "oom" for e in ours["evaluations"]) or \
        all(e["status"] != "oom" for e in ref["evaluations"])


def test_remat_recompute_on_another_thread_keeps_the_layout(world):
    """A rematerialised layer recomputes inside the backward, which on the
    card runs on autograd's device thread, where the thread-local
    annotation mesh is not installed: the recompute must lay its values
    out as the forward did (a tiny Mamba train step on a (2, 2) mesh,
    the backward run on a fresh thread)."""
    import threading
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distribution.annotate import annotation_mesh
    from repro_torch.distribution.sharding import (batch_shardings,
                                                   distribute_model,
                                                   distribute_tree)
    from repro_torch.models.transformer import init_params
    from repro_torch.training.train_step import TrainConfig, make_loss_fn
    world(4)
    mesh = _mesh22()
    cfg = get_config("mamba2-130m").tiny()
    fake = FakeTensorMode()
    with annotation_mesh(mesh), fake, implicit_replication():
        model = distribute_model(init_params(cfg, device="cpu"), mesh)
        tokens = torch.zeros((4, 65), dtype=torch.int64)
        batch = distribute_tree({"tokens": tokens}, mesh,
                                batch_shardings(mesh, {"tokens": tokens}))
        loss = make_loss_fn(cfg, TrainConfig(remat="full"))(model, batch)
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
