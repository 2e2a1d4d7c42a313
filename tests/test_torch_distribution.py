"""The port's sharding rules and annotations against the reference's.

``repro_torch.distribution`` computes specs from the mesh's axis names and
sizes alone; these tests hold them against ``repro.distribution.sharding``
on a jax ``AbstractMesh`` of the production shapes (as
``tests/test_sharding.py`` builds it), leaf for leaf: parameters for every
architecture on both meshes, caches for every decode cell, batches for
every cell. Then the reference's own sharding assertions, ``annotate``'s
resolution for the three layouts, specs as DTensor placements on a 3-D
mesh, and one run of real collectives: four CPU processes on a ``gloo``
group (a ``FileStore``, no TCP) hold a (2, 2)-sharded dense and hybrid
model against the unsharded one.
"""
import jax
import pytest
import torch
import torch.multiprocessing as mp
from torch.distributed.tensor import Replicate, Shard

try:
    from jax.sharding import AbstractMesh, AxisType
except ImportError:  # jax < 0.5 has no AxisType / kwarg-style AbstractMesh
    pytest.skip("jax.sharding.AxisType unavailable (jax too old)",
                allow_module_level=True)

import _torch_gloo_worker
from repro.configs import ARCHS as REF_ARCHS
from repro.distribution import sharding as ref_sh
from repro.launch.dryrun import input_specs as ref_input_specs
from repro.models.transformer import init_cache as ref_init_cache
from repro.models.transformer import init_params as ref_init_params
from repro_torch.configs import ARCHS, SHAPES, cell_supported
from repro_torch.distribution import annotate as an
from repro_torch.distribution import sharding as sh
from repro_torch.launch.dryrun import input_specs
from repro_torch.models import weights
from repro_torch.models.transformer import Model, init_cache

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def abstract_mesh(kind):
    shape, axes = MESHES[kind]
    return AbstractMesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))


def axes(kind):
    shape, names = MESHES[kind]
    return sh.Axes(names, shape)


def _norm(entry):
    """A spec entry with a one-axis tuple written as the axis."""
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return entry


def _norm_spec(spec):
    return tuple(_norm(e) for e in spec)


def _ref_leaves(tree):
    """'a/b/c' path -> leaf of a reference pytree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = leaf
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("kind", ["single", "multi"])
def test_param_specs_equal_the_references(arch, kind):
    """Every port parameter's spec is the reference leaf's spec without
    the leading stacked dims, which the reference never shards."""
    cfg = REF_ARCHS[arch]
    ref_params = jax.eval_shape(
        lambda: ref_init_params(cfg, jax.random.PRNGKey(0)))
    ref = {k: v.spec for k, v in _ref_leaves(
        ref_sh.param_shardings(abstract_mesh(kind), ref_params)).items()}
    ref_shapes = {k: v.shape for k, v in _ref_leaves(ref_params).items()}
    model = Model(ARCHS[arch], None, "meta")
    port = sh.param_specs(axes(kind), model)
    assert len(port) == len(list(model.parameters()))
    covered = set()
    for name, spec in port.items():
        key, index = weights._stacked(name)
        path = key.replace(".", "/")
        covered.add(path)
        full = tuple(ref[path]) + (None,) * (
            len(ref_shapes[path]) - len(tuple(ref[path])))
        assert all(e is None for e in full[:len(index)]), (name, full)
        want = full[len(index):] if tuple(ref[path]) else ()
        assert _norm_spec(spec) == _norm_spec(want), (name, spec, want)
    assert covered == set(ref)


def _decode_cells():
    return [(a, s) for a in sorted(ARCHS) for s in sorted(SHAPES)
            if SHAPES[s].kind == "decode"
            and cell_supported(ARCHS[a], SHAPES[s])[0]]


def _all_cells():
    return [(a, s) for a in sorted(ARCHS) for s in sorted(SHAPES)
            if cell_supported(ARCHS[a], SHAPES[s])[0]]


def _ref_cache_layouts(cfg, shp, kind):
    cache = jax.eval_shape(
        lambda: ref_init_cache(cfg, shp.global_batch, shp.seq_len))
    ref = ref_sh.cache_shardings(abstract_mesh(kind), cache,
                                 shp.global_batch)
    return {k: v.spec for k, v in _ref_leaves(ref).items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch,shape", _decode_cells())
@pytest.mark.parametrize("kind", ["single", "multi"])
def test_cache_specs_equal_the_references(arch, shape, kind):
    shp = SHAPES[shape]
    ref = _ref_cache_layouts(REF_ARCHS[arch], shp, kind)
    cache = init_cache(ARCHS[arch], shp.global_batch, shp.seq_len,
                       device="meta")
    port = _flat(sh.cache_specs(axes(kind), cache, shp.global_batch))
    assert set(port) == set(ref)
    for path, spec in port.items():
        assert _norm_spec(spec) == _norm_spec(ref[path]), (path, spec)


@pytest.mark.parametrize("arch,shape", _all_cells())
@pytest.mark.parametrize("kind", ["single", "multi"])
def test_batch_specs_equal_the_references(arch, shape, kind):
    shp = SHAPES[shape]
    ref_specs = ref_input_specs(REF_ARCHS[arch], shp)
    ref = {k: v.spec for k, v in _ref_leaves(
        ref_sh.batch_shardings(abstract_mesh(kind), ref_specs)).items()}
    specs = input_specs(ARCHS[arch], shp, device="meta")
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in specs.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in ref_specs.items()}
    port = sh.batch_specs(axes(kind), specs)
    assert {k: _norm_spec(v) for k, v in port.items()} == \
        {k: _norm_spec(tuple(v)) for k, v in ref.items()}


# ------------------------------------------- the reference's own assertions
def test_tp_shards_big_matrices():
    a = axes("single")
    spec = sh.spec_for_param(a, "layers/mlp/wi", (16, 2048, 8192))
    assert "model" in spec
    assert sh.spec_for_param(a, "layers/attn/wo", (16, 2048, 2048))[1] \
        == "model"


def test_moe_expert_sharding_adapts():
    a = axes("single")
    # qwen3: 128 experts divisible by 16 -> expert-parallel
    assert sh.spec_for_param(a, "layers/moe/wi",
                             (94, 128, 4096, 1536))[1] == "model"
    # grok: 8 experts NOT divisible -> FFN dim sharded instead
    s = sh.spec_for_param(a, "layers/moe/wi", (64, 8, 6144, 32768))
    assert s[1] is None and s[3] == "model"


def test_long_context_cache_context_parallel():
    """batch=1 long_500k: the sequence dim (not batch) goes on data."""
    cache = init_cache(ARCHS["gemma3-1b"], 1, 524288, device="meta")
    spec = sh.cache_specs(axes("single"), cache, 1)["k"]
    assert _norm(spec[2]) == "data" and spec[1] is None


def test_batch_specs_use_dp():
    batch = {"tokens": torch.empty((256, 4097), device="meta")}
    assert sh.batch_specs(axes("multi"), batch)["tokens"][0] == \
        ("pod", "data")


def test_opt_state_specs_mirror_the_params():
    """mu and nu placed as the parameters, step replicated, as the
    reference's ``opt_state_shardings``; the moments ``init_opt_state``
    makes from DTensor parameters carry those placements."""
    from repro_torch.training.optimizer import (OptimizerConfig,
                                                init_opt_state)
    model = Model(ARCHS["grok-1-314b"], None, "meta")
    params = dict(model.named_parameters())
    opt = init_opt_state(OptimizerConfig(), params)
    a = axes("multi")
    specs = sh.opt_state_specs(a, opt)
    assert specs["mu"] == specs["nu"] == sh.param_specs(a, params)
    assert specs["step"] == ()
    placed = sh.opt_state_shardings(a, opt)
    assert placed["step"] == (Replicate(),) * 3
    assert placed["mu"] == sh.param_shardings(a, model)


def test_param_specs_divide_every_dim():
    for arch in ARCHS:
        for kind in MESHES:
            a = axes(kind)
            model = Model(ARCHS[arch], None, "meta")
            shapes = dict(model.named_parameters())
            for name, spec in sh.param_specs(a, model).items():
                for dim, entry in zip(shapes[name].shape, spec):
                    assert dim % sh._axis_size(a, entry) == 0, (name, spec)


# ----------------------------------------------------------- placements
def test_specs_as_placements_on_a_3d_mesh():
    a = axes("multi")
    assert sh.placements(a, (("pod", "data"), "model")) == \
        (Shard(0), Shard(0), Shard(1))
    assert sh.placements(a, ("model", ("pod", "data"))) == \
        (Shard(1), Shard(1), Shard(0))
    assert sh.placements(a, (None, "data", None)) == \
        (Replicate(), Shard(1), Replicate())
    assert sh.placements(a, ()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="shards dims"):
        sh.placements(a, ("model", "model"))


def test_mesh_axes_and_pick_follow_the_reference():
    for kind in MESHES:
        for layout in an.LAYOUTS:
            assert sh.mesh_axes(axes(kind), layout) == ref_sh.mesh_axes(
                abstract_mesh(kind), layout)
        for dim in (1, 2, 8, 16, 32, 48, 512):
            for cands in (["model"], [("pod", "data")], [("data",), None],
                          [("pod", "data"), ("data",)]):
                cands = [c for c in cands
                         if c is None or all(x in MESHES[kind][1] for x in
                                             ((c,) if isinstance(c, str)
                                              else c))]
                assert sh._pick(axes(kind), dim, cands) == ref_sh._pick(
                    abstract_mesh(kind), dim, cands)


@pytest.mark.parametrize("layout", an.LAYOUTS)
@pytest.mark.parametrize("kind", ["single", "multi"])
def test_annotate_resolution_for_each_layout(layout, kind):
    """The logical axes resolve as the reference's ``_resolve`` and drop
    where they do not divide."""
    from repro.distribution import annotate as ref_an
    a = axes(kind)
    ref_mesh = abstract_mesh(kind)
    for logical in ("dp", "tp", "sp", None):
        assert an._resolve(a.names, layout, logical) == \
            ref_an._resolve(ref_mesh, layout, logical)
    dp = {"2d": tuple(n for n in a.names if n != "model"),
          "dp": a.names, "2d_seq": tuple(n for n in a.names
                                        if n != "model")}[layout]
    spec = an.resolve_spec(a, layout, (512, 4096, 2048), "dp", "sp", None)
    assert spec[0] == dp
    assert spec[1] == ("model" if layout == "2d_seq" else None)
    spec = an.resolve_spec(a, layout, (256, 4096, 12, 64),
                           "dp", None, "tp", None)
    assert spec[2] is None  # 12 heads do not divide 16
    spec = an.resolve_spec(a, layout, (3, 1, 32, 64), "dp", None, "tp")
    assert spec[0] is None and spec[2] == ("model" if layout != "dp"
                                           else None)


def test_annotate_is_a_no_op_without_a_mesh_or_dtensor():
    x = torch.ones(4, 8)
    assert an.annotate(x, "dp", "tp") is x
    with an.annotation_mesh(axes("single"), "2d_seq"):
        assert an.annotate(x, "dp", "tp") is x
        assert an.current_layout() == "2d_seq"
    assert an.current_layout() == "2d"
    with pytest.raises(ValueError):
        with an.annotation_mesh(axes("single"), "3d"):
            pass


# ------------------------------------------------- real collectives, gloo
WORLD = 4


def test_four_gloo_ranks_match_the_unsharded_models(tmp_path):
    """A (2, 2) mesh of four CPU processes over ``gloo``: a 2-layer dense
    model (gemma3, one kv head: q heads sharded, the kv head whole and
    sliced) and a 3-layer hybrid (zamba2: two Mamba layers and the shared
    block) give the unsharded logits and loss within 1e-5, float32."""
    out = tmp_path / "out.pt"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_torch_gloo_worker.run,
                         args=(r, WORLD, str(tmp_path / "store"), str(out)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    assert all(not p.is_alive() for p in procs)
    assert [p.exitcode for p in procs] == [0] * WORLD
    results = torch.load(out)
    for name, (logit_err, scale, loss_err) in results.items():
        assert logit_err <= 1e-5 * max(scale, 1.0), (name, logit_err)
        assert loss_err <= 1e-5, (name, loss_err)
