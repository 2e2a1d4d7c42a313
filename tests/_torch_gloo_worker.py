"""One rank of ``test_torch_distribution``'s four-process ``gloo`` run.

Kept apart from the test module so that a spawned rank imports torch and
``repro_torch`` only (no jax): a (2, 2) mesh over a ``FileStore``, a small
dense and a small hybrid model in float32, their logits and loss with
DTensor parameters against the same calls unsharded.
"""
import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor.experimental import implicit_replication

import repro_torch.models.layers as layers
import repro_torch.models.transformer as tr
from repro_torch.configs import ARCHS
from repro_torch.distribution import annotate as an
from repro_torch.distribution import sharding as sh
from repro_torch.training.train_step import TrainConfig, make_loss_fn

# (config, layers): gemma3 has one kv head, so its q heads shard while the
# kv head is held whole and sliced; zamba2's three layers are two Mamba
# layers and the shared attention block
MODELS = (("gemma3-1b", 2), ("zamba2-1.2b", 3))


def run(rank: int, world: int, store_path: str, out_path: str) -> None:
    """Rank ``rank``'s share; rank 0 saves {name: (max |logit error|, max
    |logit|, |loss error|)} to ``out_path``."""
    layers.COMPUTE_DTYPE = torch.float32
    tr.COMPUTE_DTYPE = torch.float32
    dist.init_process_group("gloo", init_method=f"file://{store_path}",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (2, world // 2),
                                mesh_dim_names=("data", "model"))
        results = {}
        for name, n_layers in MODELS:
            cfg = dataclasses.replace(ARCHS[name].tiny(), n_layers=n_layers)
            gen = torch.Generator().manual_seed(0)
            tokens = torch.randint(0, cfg.vocab, (4, 33), generator=gen)
            model = tr.init_params(cfg, torch.Generator().manual_seed(1),
                                   device="cpu")
            loss_fn = make_loss_fn(cfg, TrainConfig(remat="none"))
            with torch.no_grad():
                want = tr.forward(cfg, model, {"tokens": tokens[:, :-1]})
                want_loss = loss_fn(model, {"tokens": tokens})
            sh.distribute_model(model, mesh)
            batch = sh.distribute_tree(
                {"tokens": tokens}, mesh,
                sh.batch_shardings(mesh, {"tokens": tokens}))
            with an.annotation_mesh(mesh), implicit_replication(), \
                    torch.no_grad():
                got = tr.forward(cfg, model,
                                 {"tokens": batch["tokens"][:, :-1]})
                got_loss = loss_fn(model, batch)
            results[name] = (
                float((got.full_tensor() - want).abs().max()),
                float(want.abs().max()),
                float(abs(got_loss.full_tensor() - want_loss)))
        if rank == 0:
            torch.save(results, out_path)
    finally:
        dist.destroy_process_group()
