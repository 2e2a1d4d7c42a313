"""One rank of ``test_torch_faults``' four-process ``gloo`` run.

Kept apart from the test module so that a spawned rank imports torch and
``repro_torch`` only (no jax). On a (2, 2) ("data", "model") mesh over a
``FileStore``, float32, the weights and tokens the test wrote:

  * ``dp`` layout, the batch's 4 rows one a rank: a train step at
    microbatches 2 (each microbatch's 2 rows split no rank's one row, so
    they are the global rows) and the plain step at microbatch 1
    unsharded, each step's loss and gradients (caught on their way to
    AdamW);
  * ``2d_seq`` layout: the loss and gradients with DTensor parameters
    against the same calls unsharded, and the collectives of each
    sublayer output's residual pin in the forward (``residual``), caught
    with ``CommRecorder``;
  * ``2d`` layout, the families whose call sites run rank by rank
    (``summed_map``: the tied embedding's lookup on the table's shard,
    kv heads held whole beside sharded q heads, q heads the model axis
    does not divide, none on a rank, the causal conv's and the scan's
    replicated inputs, the MoE's router and its combine's all-to-all,
    the loss's logsumexp on the vocab shard): gradients with DTensor
    parameters against the same calls unsharded, on the port's own
    weights.
"""
import contextlib
import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

import repro_torch.models.layers as layers
import repro_torch.models.transformer as tr
from repro_torch.configs import get_config
from repro_torch.distribution import annotate as an
from repro_torch.distribution import sharding as sh
from repro_torch.models.weights import from_reference
from repro_torch.roofline.analysis import CommRecorder
from repro_torch.training import optimizer as opt
from repro_torch.training import train_step as ts


def _whole(t):
    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().numpy().copy()


def _step(cfg, tree, batch, microbatches, mesh=None, layout="2d"):
    """(loss, {name: gradient}) of one train step (remat none)."""
    model = from_reference(cfg, tree, device="cpu")
    if mesh is not None:
        sh.distribute_model(model, mesh)
        batch = sh.distribute_tree(batch, mesh,
                                   sh.batch_shardings(mesh, batch, layout))
    opt_cfg = opt.OptimizerConfig(total_steps=10)
    state = {"params": model, "opt": opt.init_opt_state(
        opt_cfg, dict(model.named_parameters()))}
    caught = {}
    update = ts.adamw_update

    def spy(cfg_, params, grads, opt_state):
        caught.update(grads)
        return update(cfg_, params, grads, opt_state)

    ts.adamw_update = spy
    try:
        step = ts.make_train_step(cfg, opt_cfg, ts.TrainConfig(
            microbatches=microbatches, remat="none"))
        with (an.annotation_mesh(mesh, layout) if mesh is not None
              else contextlib.nullcontext()), implicit_replication():
            _, metrics = step(state, batch)
    finally:
        ts.adamw_update = update
    return (float(_whole(metrics["loss"])),
            {k: _whole(g) for k, g in caught.items()})


def _grads(cfg, model, batch, loss_fn):
    loss = loss_fn(model, batch)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return float(_whole(loss)), {n: _whole(g) for n, g in zip(names, grads)}


def _family(name, n_layers, overrides, tokens, mesh, dims=None):
    """2d: (loss, grads) unsharded and with DTensor parameters, of the
    tiny config of ``name`` with ``n_layers`` and ``overrides``, on
    ``mesh`` or on a mesh of ``dims`` ((shape, names)) where given."""
    if dims is not None:
        mesh = init_device_mesh("cpu", dims[0], mesh_dim_names=dims[1])
    cfg = dataclasses.replace(get_config(name).tiny(), n_layers=n_layers,
                              **overrides)
    batch = {"tokens": tokens % cfg.vocab}
    if cfg.family == "audio":
        batch["audio_embeds"] = torch.randn(
            (tokens.shape[0], cfg.n_audio_frames, cfg.d_model),
            generator=torch.Generator().manual_seed(2))
    loss_fn = ts.make_loss_fn(cfg, ts.TrainConfig(remat="none"))
    model = tr.init_params(cfg, torch.Generator().manual_seed(1),
                           device="cpu")
    plain = _grads(cfg, model, batch, loss_fn)
    sh.distribute_model(model, mesh)
    batch = sh.distribute_tree(batch, mesh, sh.batch_shardings(mesh, batch))
    with an.annotation_mesh(mesh), implicit_replication():
        return plain, _grads(cfg, model, batch, loss_fn)


def _seq_parallel(cfg, tree, tokens, mesh):
    """2d_seq: (loss, grads) unsharded, (loss, grads) sharded, and the
    forward's collectives of each residual pin."""
    loss_fn = ts.make_loss_fn(cfg, ts.TrainConfig(remat="none"))
    model = from_reference(cfg, tree, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    loss = loss_fn(model, {"tokens": tokens})
    plain = (float(loss), dict(zip(names, (
        g.numpy().copy() for g in torch.autograd.grad(
            loss, list(model.parameters()))))))
    sh.distribute_model(model, mesh)
    batch = sh.distribute_tree({"tokens": tokens}, mesh, sh.batch_shardings(
        mesh, {"tokens": tokens}, "2d_seq"))
    pins = []
    original = tr.residual

    def counted(h):
        with CommRecorder() as comm:
            out = original(h)
        pins.append({str(k).split(".")[-1]: v
                     for k, v in comm.get_comm_counts().items()})
        return out

    tr.residual = counted
    try:
        with an.annotation_mesh(mesh, "2d_seq"), implicit_replication():
            loss = loss_fn(model, batch)
            grads = torch.autograd.grad(loss, list(model.parameters()))
    finally:
        tr.residual = original
    sharded = (float(_whole(loss)), {n: _whole(g)
                                     for n, g in zip(names, grads)})
    return plain, sharded, pins


def run(rank: int, world: int, store_path: str, in_path: str,
        out_path: str) -> None:
    """Rank ``rank``'s share; rank 0 saves the results to ``out_path``."""
    layers.COMPUTE_DTYPE = torch.float32
    tr.COMPUTE_DTYPE = torch.float32
    dist.init_process_group("gloo", init_method=f"file://{store_path}",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (2, world // 2),
                                mesh_dim_names=("data", "model"))
        given = torch.load(in_path, weights_only=False)
        cfg = dataclasses.replace(get_config(given["arch"]).tiny(),
                                  n_layers=given["layers"])
        tree, tokens = given["tree"], torch.as_tensor(given["tokens"])
        out = {"plain": _step(cfg, tree, {"tokens": tokens}, 1),
               "microbatches": _step(cfg, tree, {"tokens": tokens}, 2,
                                     mesh, "dp")}
        out["seq"] = _seq_parallel(cfg, tree, tokens, mesh)
        out["families"] = {key: _family(*spec[:3], tokens, mesh,
                                        *spec[3:])
                           for key, spec in given["families"].items()}
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()
