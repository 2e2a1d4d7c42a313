"""Multi-pod dry run: every (architecture × input shape × mesh) cell
traced on one rank of a fake world, no allocation.

Port of ``src/repro/launch/dryrun.py``. The reference lowers and compiles
each cell from ``ShapeDtypeStruct``s against 512 host devices and records
XLA's ``memory_analysis()``, ``cost_analysis()`` and the collectives parsed
from the HLO, for the roofline analysis. Here a cell runs one step of its
kind (train: ``training.train_step`` with AdamW moments sharded like the
parameters; prefill; decode against a ``seq_len``-deep cache) on rank 0 of
a fake world of 256 or 512 ranks (``launch.mesh.init_fake_world``), under

  * ``FakeTensorMode``: every tensor is a fake, with shapes and dtypes but
    no storage, so full-size models trace in one process; the kernels are
    operators with fake implementations and flop formulas
    (``kernels/flash_attention.py``, ``kernels/ssd.py``);
  * DTensor: parameters placed by ``param_shardings``, inputs by
    ``batch_shardings``, caches by ``cache_shardings``, the model's
    ``annotate`` pins resolved against ``annotation_mesh``; DTensor turns
    each op into its local op and the collectives it needs;
  * ``_Tracer``, the port's dispatch mode under DTensor, which sees the
    local ops: FLOPs by ``FlopCounterMode``'s formulas for the products
    (``torch.utils.flop_counter.flop_registry``; ``FlopCounterMode``
    itself counts a DTensor op at its global shapes) and, for every other
    op, as XLA's cost analysis counts it (``elementwise_flops``), so the
    count is the counterpart of ``cost_analysis()["flops"]``, bytes read and
    written (each non-view op's input and output bytes, the counterpart
    of XLA's ``bytes accessed``), and memory (live storages: arguments,
    outputs, temporaries, aliases and the peak; a tensor on the ``meta``
    device, such as the global cache shapes prefill lays its shards out
    by, holds none);
  * ``roofline.analysis.CommRecorder`` (``CommDebugMode``), which sees the
    collectives; ``collectives_from_comm`` prices them.

What changed besides: the port's layers are a Python loop, so the counted
FLOPs and bytes cover every layer, where XLA counts a scan body once
(reference ``:187-188``); the roofline terms still take ``analytic_cost``,
as the reference's do. ``lower_cell`` returns a ``Traced`` record in
place of a lowered computation, and ``cost_analysis_dict`` reads it.
``run_cell`` writes the reference's record keys (``compile_s`` is the
trace's wall, there being no separate compile), so ``autotune/perf.py``
reads it unchanged. ``main()`` starts the fake world (512 ranks) before
anything else, as the reference's forces 512 host devices; a library
importer starts none.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both --out experiments/dryrun [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import multiprocessing
import os
import time
import traceback
import weakref
from concurrent.futures import ProcessPoolExecutor

import torch
from torch._guards import active_fake_mode
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from .. import cuda
from ..configs import ARCHS, SHAPES, ArchConfig, ShapeConfig, cell_supported
from ..distribution.annotate import annotation_mesh
from ..distribution.sharding import (batch_shardings, cache_shardings,
                                     distribute_model, distribute_tree,
                                     sharded_zeros)
from ..models.transformer import decode_step, init_cache, init_params, prefill
from ..roofline.analysis import (CommRecorder, analytic_cost,
                                 collectives_from_comm, model_flops,
                                 roofline)
from ..training.optimizer import OptimizerConfig, init_opt_state
from ..training.train_step import TrainConfig, make_train_step
from .mesh import init_fake_world, make_production_mesh

_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional", "_dtensor")


# ------------------------------------------------------------- input specs
def input_specs(cfg: ArchConfig, shape: ShapeConfig, device=None) -> dict:
    """Tensors with the reference's shapes and dtypes for every model input
    of this cell (fakes under ``FakeTensorMode``; zeros otherwise)."""
    b, s = shape.global_batch, shape.seq_len
    f32, i32 = torch.float32, torch.int32

    def t(shp, dt):
        return torch.zeros(shp, dtype=dt, device=device)

    if shape.kind in ("train", "prefill"):
        s1 = s + 1 if shape.kind == "train" else s
        batch = {"tokens": t((b, s1), i32)}
        if cfg.family == "vlm":
            batch["positions"] = t((b, s1, 3), i32)
            batch["patch_embeds"] = t((b, cfg.n_patches, cfg.d_model), f32)
        if cfg.family == "audio":
            batch["audio_embeds"] = t((b, cfg.n_audio_frames, cfg.d_model),
                                      f32)
        return batch
    # decode: one new token against a seq_len-deep cache
    return {"tokens": t((b, 1), i32), "cache_len": t((), i32)}


# ------------------------------------------------------------------ tracer
@dataclasses.dataclass
class Traced:
    """One rank's account of a traced cell: FLOPs and bytes read and
    written by its local ops, its memory in bytes (``argument``,
    ``output``, ``temp``, ``alias``, ``peak``: peak = argument + output +
    temp - alias, the reference's formula), the collectives its
    ``CommRecorder`` saw (``comm``, priced by ``collectives_from_comm``
    against ``mesh``), the local ops counted and the trace's wall."""
    flops: float
    bytes_accessed: float
    memory: dict
    comm: CommRecorder
    mesh: object
    n_ops: int
    seconds: float

    def collectives(self):
        return collectives_from_comm(self.comm, self.mesh)


# XLA's cost analysis counts these apart, as transcendentals, not flops
_TRANSCENDENTAL = frozenset(
    "exp exp2 expm1 log log1p log2 log10 tanh sigmoid sin cos tan rsqrt "
    "sqrt erf erfc erfinv pow".split())


def elementwise_flops(func, ins: list, outs: list) -> int:
    """The flops XLA's ``HloCostAnalysis`` gives an op that is not a
    product: one an output element of an arithmetic pointwise op (a
    comparison, a select and a dtype conversion included; none for a
    transcendental, a copy or a view), one an input element of a
    reduction, a scan or a softmax, one a value an accumulating scatter
    adds."""
    name = func._overloadpacket.__name__.rstrip("_")
    tags = func.tags
    if torch.Tag.pointwise in tags:
        if name in _TRANSCENDENTAL or name == "clone":
            return 0
        return sum(t.numel() for t in outs)
    if name == "_to_copy":
        same = outs and ins and outs[0].dtype == ins[0].dtype
        return 0 if same else outs[0].numel()
    if torch.Tag.reduction in tags or name in (
            "cumsum", "_softmax", "_log_softmax"):
        return ins[0].numel() if ins else 0
    if name in ("index_put", "scatter_add", "index_add"):
        return ins[-1].numel() if ins else 0
    return 0


class _Tracer(TorchDispatchMode):
    """Counts the local ops of one rank (DTensor ops are left to DTensor:
    ``NotImplemented`` lets it run them as local ops, which come back
    here). ``track`` registers tensors whose storages are live from the
    start (the arguments)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.n_ops = 0
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()
        self._fake_mode = None

    def __enter__(self):
        self._fake_mode = active_fake_mode()
        # DTensor derives each op's output shapes by running it on fakes of
        # the global shapes under the active fake mode: those runs pass
        # through here too and are not the rank's ops
        self._meta_fn = ShardingPropagator._propagate_tensor_meta_non_cached
        self._propagating = 0
        tracer = self

        def meta(prop, op_schema):
            tracer._propagating += 1
            try:
                return tracer._meta_fn(prop, op_schema)
            finally:
                tracer._propagating -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = meta
        return super().__enter__()

    def __exit__(self, *args):
        ShardingPropagator._propagate_tensor_meta_non_cached = self._meta_fn
        return super().__exit__(*args)

    def track(self, tensors) -> int:
        """Register the storages of ``tensors`` (local tensors); returns
        the bytes newly registered."""
        before = self.live
        for t in tensors:
            self._add(t.untyped_storage())
        return self.live - before

    def _add(self, storage) -> None:
        if storage in self._seen:
            return
        n = storage.nbytes()
        self._seen[storage] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is DTensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        namespace = func.namespace
        if namespace == "prim":  # metadata queries (device, layout)
            return func(*args, **kwargs)
        if (func is torch.ops._c10d_functional.wait_tensor.default
                and self._fake_mode is not None):
            return args[0]  # the fake wait would make a new tensor
        out = func(*args, **kwargs)
        if self._propagating:
            return out
        self.n_ops += 1
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if namespace not in _COLLECTIVE_NS and not func.is_view:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
            else:
                self.flops += elementwise_flops(func, ins, outs)
        for t in outs:
            if t.device.type != "meta":  # shapes alone, no memory
                self._add(t.untyped_storage())
        return out


# ------------------------------------------------------------------- cells
def lower_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, *,
               microbatches: int = 1, remat: str = "full",
               layout: str = "2d") -> Traced:
    """Trace one step of the cell on rank 0 of ``mesh`` (a fake world);
    returns its ``Traced`` record. Raises on sharding or tracing errors."""
    t0 = time.perf_counter()
    device = mesh.device_type
    with contextlib.ExitStack() as stack:
        stack.enter_context(annotation_mesh(mesh, layout))
        stack.enter_context(FakeTensorMode())
        stack.enter_context(implicit_replication())
        step, args = _build(cfg, shape, mesh, device, microbatches, remat,
                            layout)
        inputs = _tensors(args)
        arg_storages = {t.untyped_storage()._cdata for t in inputs}
        comm = stack.enter_context(CommRecorder())
        tracer = stack.enter_context(_Tracer())
        argument = tracer.track(inputs)
        seen, output, alias = set(), 0, 0
        for t in _tensors(step(*args)):
            st = t.untyped_storage()
            if st._cdata in seen:
                continue
            seen.add(st._cdata)
            output += st.nbytes()
            if st._cdata in arg_storages:
                alias += st.nbytes()
        peak = tracer.peak
    memory = {"argument": argument, "output": output, "alias": alias,
              "temp": peak - argument - output + alias, "peak": peak}
    return Traced(tracer.flops, tracer.bytes, memory, comm, mesh,
                  tracer.n_ops, time.perf_counter() - t0)


def _tensors(tree) -> list:
    """The local tensors of a tree's leaves (a ``Model``'s parameters
    included)."""
    out = []
    for t in tree_leaves(tree):
        if isinstance(t, torch.nn.Module):
            out += _tensors(list(t.parameters()))
        elif isinstance(t, torch.Tensor):
            out.append(t.to_local() if isinstance(t, DTensor) else t)
    return out


def _build(cfg, shape, mesh, device, microbatches, remat, layout):
    """(step, args): the cell's step and its DTensor arguments."""
    model = distribute_model(init_params(cfg, device=device), mesh)
    specs = input_specs(cfg, shape, device)
    b = shape.global_batch
    if shape.kind == "train":
        opt_cfg = OptimizerConfig()
        # the moments are zeros like the DTensor parameters: placed alike
        state = {"params": model, "opt": init_opt_state(
            opt_cfg, dict(model.named_parameters()))}
        batch = distribute_tree(specs, mesh,
                                batch_shardings(mesh, specs, layout))
        # the step updates the state in place: its output aliases it
        return make_train_step(cfg, opt_cfg, TrainConfig(
            microbatches=microbatches, remat=remat)), (state, batch)
    if shape.kind == "prefill":
        batch = distribute_tree(specs, mesh,
                                batch_shardings(mesh, specs, layout))

        def step(model, batch):
            with torch.no_grad():
                return prefill(cfg, model, batch, max_len=shape.seq_len)
        return step, (model, batch)
    cache = init_cache(cfg, b, shape.seq_len, device="meta")
    cache = sharded_zeros(cache, mesh, cache_shardings(mesh, cache, b,
                                                       layout), device)
    new = {"tokens": specs["tokens"]}
    tokens = distribute_tree(new, mesh, batch_shardings(mesh, new,
                                                        layout))["tokens"]
    cache_len = torch.full((), shape.seq_len - 1, dtype=torch.int32,
                           device=device)

    def step(model, cache, tokens, cache_len):
        with torch.no_grad():
            return decode_step(cfg, model, cache, tokens, cache_len)
    return step, (model, cache, tokens, cache_len)


def cost_analysis_dict(traced: Traced) -> dict:
    """``{"flops": ..., "bytes accessed": ...}`` of one rank, the keys of
    XLA's ``cost_analysis()``."""
    return {"flops": traced.flops, "bytes accessed": traced.bytes_accessed}


def run_cell(arch_name: str, shape_name: str, mesh_kind: str, *,
             microbatches: int = 1, remat: str = "full", layout: str = "2d",
             collect_hlo: bool = True, device=None) -> dict:
    """One cell's record, the reference's keys. Needs a fake world of at
    least the mesh's ranks (``init_fake_world``)."""
    cfg = ARCHS[arch_name]
    shape = SHAPES[shape_name]
    rec: dict = {"arch": arch_name, "shape": shape_name, "mesh": mesh_kind,
                 "microbatches": microbatches, "remat": remat,
                 "layout": layout}
    ok, reason = cell_supported(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                device=device)
    n_chips = mesh.size()
    try:
        traced = lower_cell(cfg, shape, mesh, microbatches=microbatches,
                            remat=remat, layout=layout)
        cost = cost_analysis_dict(traced)
        coll = traced.collectives() if collect_hlo else None
        mf = model_flops(cfg, shape)
        a_flops, a_bytes = analytic_cost(cfg, shape, remat, n_chips)
        rl = roofline(a_flops, a_bytes,
                      coll.total_wire_bytes if coll else 0.0, n_chips, mf)
        mem = traced.memory
        rec.update(
            status="ok", n_chips=n_chips, lower_s=round(traced.seconds, 2),
            compile_s=round(traced.seconds, 2),
            memory={
                "argument_bytes_per_chip": mem["argument"],
                "output_bytes_per_chip": mem["output"],
                "temp_bytes_per_chip": mem["temp"],
                "alias_bytes_per_chip": mem["alias"],
                "peak_bytes_per_chip": mem["peak"],
            },
            cost={"hlo_flops_per_chip": cost["flops"],
                  "hlo_bytes_per_chip": cost["bytes accessed"],
                  "analytic_flops_per_chip": a_flops,
                  "analytic_bytes_per_chip": a_bytes},
            collectives=coll.to_json() if coll else None,
            roofline=rl.to_json(), local_ops=traced.n_ops,
        )
    except Exception as e:  # a cell's failure is its record, not the run's
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    return rec


def run_cells(cells, *, workers: int = 1, device=None, **kw):
    """``run_cell`` records of ``cells`` ((arch, shape, mesh kind) each),
    yielded in order. With ``workers`` > 1 the cells run in as many
    spawned processes, each with its own fake world of 512 ranks (the
    caller needs none); otherwise here, in the caller's world."""
    if workers <= 1:
        for cell in cells:
            yield run_cell(*cell, device=device, **kw)
        return
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(workers, mp_context=ctx,
                             initializer=init_fake_world,
                             initargs=(512,)) as pool:
        futures = [pool.submit(run_cell, *cell, device=device, **kw)
                   for cell in cells]
        for f in futures:
            yield f.result()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="full", choices=["none", "dots", "full"])
    ap.add_argument("--layout", default="2d", choices=["2d", "dp", "2d_seq"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--device", default=None,
                    help="the mesh's device; the card unless 'cpu'")
    ap.add_argument("--workers", type=int, default=1,
                    help="processes tracing cells at once, each with its "
                         "own fake world")
    args = ap.parse_args(argv)
    device = cuda.resolve_device(args.device)
    if args.workers <= 1:
        init_fake_world(512)

    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    os.makedirs(args.out, exist_ok=True)

    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]
    n_ok = n_err = n_skip = 0
    t_all = time.perf_counter()
    for (arch, shape, mesh_kind), rec in zip(cells, run_cells(
            cells, workers=args.workers, device=device,
            microbatches=args.microbatches, remat=args.remat,
            layout=args.layout)):
        path = os.path.join(args.out, f"{arch}__{shape}__{mesh_kind}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        if rec["status"] == "ok":
            n_ok += 1
            r = rec["roofline"]
            print(f"[ok]   {arch:22s} {shape:12s} {mesh_kind:6s} "
                  f"trace={rec['compile_s']:7.1f}s "
                  f"peakmem={rec['memory']['peak_bytes_per_chip']/2**30:6.2f}GiB "
                  f"dom={r['dominant']:10s} "
                  f"useful={r['useful_ratio']:6.3f}", flush=True)
        elif rec["status"] == "skipped":
            n_skip += 1
            print(f"[skip] {arch:22s} {shape:12s} {mesh_kind:6s} "
                  f"{rec['reason']}", flush=True)
        else:
            n_err += 1
            print(f"[ERR]  {arch:22s} {shape:12s} {mesh_kind:6s} "
                  f"{rec['error']}", flush=True)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"({time.perf_counter() - t_all:.1f}s)")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
