"""The port's checkpoints (``repro_torch.checkpoint.manager``) on the CPU:
the counterparts of tests/test_fault_tolerance.py's restart, atomic
write, keep-k and async tests, and the on-disk layout shared with the
reference's ``CheckpointManager`` (each package restores the other's
file, leaf for leaf). On the CPU the model's kernel call sites run their
plain versions (the wrappers' own dispatch).

Tolerances: none. A restored state equals the saved one bit for bit; a
restart reproduces the uninterrupted run's losses and state bit for bit
(the same float32 arithmetic in the same order on one device); a bf16
``mu`` goes through the file as float32, which holds it exactly.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.training import optimizer as ref_opt
from repro.training import train_step as ref_ts
import repro_torch.configs as configs
from repro_torch.checkpoint.manager import (AsyncCheckpointer,
                                            CheckpointManager, flatten_state)
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_step import (TrainConfig, init_train_state,
                                             make_train_step)


def _setup(name="olmo-1b", mu_dtype="float32"):
    cfg = configs.get_config(name).tiny()
    opt = OptimizerConfig(peak_lr=1e-3, warmup_steps=2, total_steps=20,
                          mu_dtype=mu_dtype)
    step = make_train_step(cfg, opt, TrainConfig(remat="none"))
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=16,
                                    global_batch=4), cfg)
    return cfg, opt, step, pipe


def _fresh(cfg, opt, seed=0):
    return init_train_state(cfg, opt, torch.Generator().manual_seed(seed),
                            device="cpu")


def _run(step, state, pipe, start, n):
    losses = []
    for i in range(start, start + n):
        state, m = step(state, pipe.batch_at(i))
        losses.append(float(m["loss"]))
    return state, losses


def _assert_states_equal(a: dict, b: dict) -> None:
    fa, fb = flatten_state(a), flatten_state(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_restart_is_bit_exact(tmp_path):
    cfg, opt, step, pipe = _setup()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    full_state, full_losses = _run(step, _fresh(cfg, opt), pipe, 0, 8)
    # crash after 4: save, "restart", resume from the checkpoint
    mid_state, l1 = _run(step, _fresh(cfg, opt), pipe, 0, 4)
    mgr.save(4, mid_state)
    restored = mgr.restore(4, _fresh(cfg, opt, seed=5))
    assert int(restored["opt"]["step"]) == 4
    end_state, l2 = _run(step, restored, pipe, 4, 4)
    assert l1 + l2 == full_losses
    _assert_states_equal(full_state, end_state)


def test_atomic_write_no_partial_files(tmp_path):
    cfg, opt, _, _ = _setup()
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, _fresh(cfg, opt), meta={"arch": cfg.name})
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    assert mgr.latest_step() == 1
    with open(tmp_path / "ckpt_00000001.npz.json") as f:
        assert json.load(f) == {"step": 1, "arch": cfg.name}


def test_keep_k_garbage_collection(tmp_path):
    cfg, opt, _, _ = _setup()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = _fresh(cfg, opt)
    for s in (1, 2, 3, 4):
        mgr.save(s, state)
    assert mgr.all_steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == [
        "ckpt_00000003.npz", "ckpt_00000003.npz.json", "ckpt_00000004.npz",
        "ckpt_00000004.npz.json"]


def test_async_checkpointer_overlaps_and_matches(tmp_path):
    """The snapshot is taken on the caller's thread: a train step that
    overwrites the state in place while the write runs does not reach the
    file."""
    cfg, opt, step, pipe = _setup()
    mgr = CheckpointManager(str(tmp_path), keep=3)
    ac = AsyncCheckpointer(mgr)
    state, _ = _run(step, _fresh(cfg, opt), pipe, 0, 2)
    expected = flatten_state(state)
    ac.save(7, state)
    state, _ = _run(step, state, pipe, 7, 1)  # train while writing
    ac.wait()
    restored = flatten_state(mgr.restore(7, _fresh(cfg, opt, seed=5)))
    assert restored.keys() == expected.keys()
    for k in expected:
        np.testing.assert_array_equal(restored[k], expected[k], err_msg=k)
    assert int(restored["opt/step"]) == 2 and int(state["opt"]["step"]) == 3


def _ref_state(name, mu_dtype):
    ref_cfg = ref_configs.get_config(name).tiny()
    opt = ref_opt.OptimizerConfig(peak_lr=1e-3, warmup_steps=2,
                                  total_steps=20, mu_dtype=mu_dtype)
    state = ref_ts.init_train_state(ref_cfg, opt, jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, ref_cfg.vocab, (2, 17))
    state, _ = jax.jit(ref_ts.make_train_step(
        ref_cfg, opt, ref_ts.TrainConfig(remat="none")))(
        state, {"tokens": jnp.asarray(toks, jnp.int32)})
    return ref_cfg, opt, state


def _flat_tree(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat_tree(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(value)
    return out


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["olmo-1b", "zamba2-1.2b"])
def test_reference_checkpoint_restored_by_port(tmp_path, name, mu_dtype):
    """A checkpoint the reference's manager wrote (after one of its train
    steps, so the moments are not zero) restores into the port's state:
    every leaf equal, bf16 moments bit for bit."""
    _, _, ref_state = _ref_state(name, mu_dtype)
    RefManager(str(tmp_path)).save(1, ref_state)
    cfg, opt, _, _ = _setup(name, mu_dtype)
    state = CheckpointManager(str(tmp_path)).restore(1, _fresh(cfg, opt, 3))
    assert state["opt"]["mu"]["embed"].dtype == getattr(torch, mu_dtype)
    ours = flatten_state(state)
    ref = {k: v.astype(np.float32) if v.dtype == jnp.bfloat16 else v
           for k, v in _flat_tree(jax.tree.map(np.asarray,
                                               ref_state)).items()}
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["olmo-1b", "zamba2-1.2b"])
def test_port_checkpoint_restored_by_reference(tmp_path, name, mu_dtype):
    """A checkpoint the port wrote (after one of its train steps) restores
    through the reference's ``CheckpointManager.restore`` into the
    reference's state template: the same keys, shapes and values."""
    cfg, opt, step, pipe = _setup(name, mu_dtype)
    state, _ = _run(step, _fresh(cfg, opt), pipe, 0, 1)
    CheckpointManager(str(tmp_path)).save(1, state)
    ref_cfg = ref_configs.get_config(name).tiny()
    ref_opt_cfg = ref_opt.OptimizerConfig(mu_dtype=mu_dtype)
    template = jax.eval_shape(lambda: ref_ts.init_train_state(
        ref_cfg, ref_opt_cfg, jax.random.PRNGKey(0)))
    restored = RefManager(str(tmp_path)).restore(1, template)
    assert restored["opt"]["mu"]["embed"].dtype == jnp.dtype(mu_dtype)
    ref = _flat_tree(restored)
    ours = flatten_state(state)
    assert ref.keys() == ours.keys()
    for k in ours:
        np.testing.assert_array_equal(np.asarray(ref[k], ours[k].dtype),
                                      ours[k], err_msg=k)
