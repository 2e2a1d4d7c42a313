"""The port's training path (``repro_torch.data``, ``repro_torch.training``,
``launch.train``, the two kernel call sites' backward passes) against the
reference's (``repro.data``, ``repro.training``, ``jax.vjp`` / ``jax.grad``)
on the CPU, on inputs made with numpy from a seed and on weights shared
through ``models.weights.from_reference`` / ``to_reference``.

On the CPU the port's flash-attention and SSD call sites run their
kernels' plain versions (the wrappers' own dispatch: ``attention_plain``
with its logsumexp, ``ssd_plain`` with its chunks' incoming states) as
the forward of ``_Flash`` / ``_SSDScan``; the backward is the port's own
PyTorch code on either device. The card runs the kernels
(tests/test_torch_cuda.py, chip_smoke.py phase 8).

Tolerances:

* Batches: bit-identical (numpy on both sides).
* ``schedule``: 1e-6 relative (float32 on both sides; ``cos`` may differ
  by an ulp). One ``adamw_update``: 1e-6 relative and 1e-9 absolute on
  each parameter and moment (float32 arithmetic in the reference's order;
  the global norm sums in another order, which moves the clip scale by an
  ulp or so).
* Losses (``cross_entropy``, ``chunked_cross_entropy``): 1e-5.
* Backward passes at the call sites: a relative Frobenius error
  ``GRAD_TOL`` = 1e-4 on each gradient (float32; the sums run in another
  order: the port's backward visits 4-key blocks and all chunks at once).
* Whole models in float32 (both packages' ``COMPUTE_DTYPE`` set to
  float32, as tests/test_torch_models.py does): the loss within 1e-4
  relative, each leaf's gradient within a relative Frobenius error of
  1e-3. In bf16, the trained dtype: the loss within 0.02 relative, each
  leaf's gradient within a relative Frobenius error of 0.1. A bf16 step
  is 2^-8 of a value and the two frameworks round at different places
  (XLA keeps fused chains in float32; the reference's embedding gradient
  is scattered in bf16, the port's in float32); the largest leaf error
  measured here is about 0.04. qwen3-moe-235b-a22b is held in float32
  only (``FLOAT32_ONLY``): in bf16 the two packages route a few tokens
  to other experts (tests/test_torch_models.py says why).
* One train step (float32): parameters within 1e-5 relative and
  ``STEP_ATOL`` = 3e-5, a tenth of the learning rate, absolute of the
  reference's. AdamW's first step moves a parameter by lr g / (|g| +
  eps), about lr (3e-4 here) whatever |g|, except where |g| is within a
  few thousand eps (1e-8) of zero: there float32 noise in g moves the
  step by up to a few percent of lr (measured: 3e-6 on 25 of the 32,768
  embedding entries, 1.5e-5 on one of zamba2's). A wrong learning rate,
  decay or bias correction moves every parameter by more. The loss
  within 1e-4 relative, the grad norm within 1e-3.
* Remat policies, on the port alone: the loss within 1e-6 relative,
  gradients within 1e-5 relative Frobenius error (remat recomputes the
  same float32 values). Microbatches 2 against 1: the loss within 1e-5
  relative, the embedding after one step within 1e-5 relative and
  ``STEP_ATOL`` (the sums regroup; the same AdamW effect).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.transformer as ref_tf
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import TokenPipeline as RefPipeline
from repro.models import attention as ref_attn
from repro.models import mamba2 as ref_mamba
from repro.training import optimizer as ref_opt
from repro.training import train_step as ref_ts
import repro_torch.configs as configs
import repro_torch.models.transformer as tf
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd
from repro_torch.launch import train as train_launcher
from repro_torch.models import attention, mamba2
from repro_torch.models.weights import from_reference, to_reference
from repro_torch.training import optimizer, train_step as ts

GRAD_TOL = 1e-4
MODEL_TOL = {"float32": (1e-4, 1e-3), "bfloat16": (0.02, 0.1)}
ARCHS = ["gemma3-1b", "mamba2-130m", "zamba2-1.2b", "qwen3-moe-235b-a22b",
         "whisper-small", "qwen2-vl-2b"]
B, S = 2, 40   # tokens (B, S + 1); S above gemma3 tiny's window of 32
STEP_ATOL = 3e-5


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(ours, ref) -> float:
    ours = np.asarray(ours, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(ours - ref) / max(np.linalg.norm(ref),
                                                    1e-30))


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(value, np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _ref_params(name):
    return jax.jit(ref_tf.init_params, static_argnums=0)(
        ref_configs.get_config(name).tiny(), jax.random.PRNGKey(0))


def _model(name):
    cfg = configs.get_config(name).tiny()
    return cfg, from_reference(cfg, jax.tree.map(np.asarray,
                                                 _ref_params(name)),
                               device="cpu")


def _tokens(cfg, seed=1, rows=B):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (rows, S + 1)).astype(np.int32)


def _batch(cfg, seed=1, rows=B):
    """Tokens (rows, S + 1) and the entries of ``cfg``'s family, in numpy:
    audio embeddings (normal), patch embeddings (normal x 0.02), M-RoPE
    positions 0..S (the train step drops the last, as the tokens')."""
    rng = np.random.default_rng(seed + 100)
    out = {"tokens": _tokens(cfg, seed, rows)}
    if cfg.family == "audio":
        out["audio_embeds"] = _randn(rng, rows, cfg.n_audio_frames,
                                     cfg.d_model)
    if cfg.family == "vlm":
        out["patch_embeds"] = _randn(rng, rows, cfg.n_patches, cfg.d_model,
                                     scale=0.02)
        out["positions"] = np.ascontiguousarray(np.broadcast_to(
            np.arange(S + 1, dtype=np.int32)[None, :, None], (rows, S + 1,
                                                              3)))
    return out


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("seed,step,shards,shard", [
    (0, 0, 1, 0), (7, 5, 2, 1), (3, 123, 4, 2), (11, 9, 4, 3)])
def test_pipeline_batches_bit_identical(seed, step, shards, shard):
    ref = RefPipeline(RefDataConfig(vocab=1000, seq_len=24, global_batch=8,
                                    seed=seed), None, shards, shard)
    ours = TokenPipeline(DataConfig(vocab=1000, seq_len=24, global_batch=8,
                                    seed=seed), None, shards, shard)
    for a, b in ((ours.global_batch_at(step), ref.global_batch_at(step)),
                 (ours.batch_at(step), ref.batch_at(step))):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("name", ["qwen2-vl-2b", "whisper-small"])
def test_pipeline_vlm_and_audio_branches_bit_identical(name):
    cfg = configs.get_config(name).tiny()
    ref_cfg = ref_configs.get_config(name).tiny()
    ours = TokenPipeline(DataConfig(cfg.vocab, 16, 4, seed=2), cfg)
    ref = RefPipeline(RefDataConfig(ref_cfg.vocab, 16, 4, seed=2), ref_cfg)
    a, b = ours.batch_at(3), ref.batch_at(3)
    assert a.keys() == b.keys() and len(a) == (3 if cfg.family == "vlm"
                                               else 2)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


# --------------------------------------------------------------- optimizer
def test_schedule_matches_reference():
    cfg = optimizer.OptimizerConfig(peak_lr=3e-4, warmup_steps=10,
                                    total_steps=100)
    ref_cfg = ref_opt.OptimizerConfig(peak_lr=3e-4, warmup_steps=10,
                                      total_steps=100)
    for step in (0, 1, 5, 10, 11, 37, 55, 99, 100, 130):
        ours = optimizer.schedule(cfg, step)
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(float(ours), float(ref_opt.schedule(
            ref_cfg, step)), rtol=1e-6)


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(mu_dtype):
    """Two steps from zero moments, gradients large enough that the
    global-norm clip scales them (norm about 40 against clip 1)."""
    rng = np.random.default_rng(4)
    shapes = {"a": (8, 16), "b": (16,), "c": (3, 5, 7)}
    params = {k: _randn(rng, *s) for k, s in shapes.items()}
    grads = [{k: _randn(rng, *s, scale=3.0) for k, s in shapes.items()}
             for _ in range(2)]
    kw = dict(peak_lr=1e-2, warmup_steps=1, total_steps=10,
              mu_dtype=mu_dtype)
    cfg, ref_cfg = optimizer.OptimizerConfig(**kw), \
        ref_opt.OptimizerConfig(**kw)
    ours = {k: _t(v) for k, v in params.items()}
    state = optimizer.init_opt_state(cfg, ours)
    assert state["mu"]["a"].dtype == getattr(torch, mu_dtype)
    ref_p = {k: jnp.asarray(v) for k, v in params.items()}
    ref_state = ref_opt.init_opt_state(ref_cfg, ref_p)
    for g in grads:
        _, _, m = optimizer.adamw_update(cfg, ours,
                                         {k: _t(v) for k, v in g.items()},
                                         state)
        ref_p, ref_state, ref_m = ref_opt.adamw_update(
            ref_cfg, ref_p, {k: jnp.asarray(v) for k, v in g.items()},
            ref_state)
        assert float(m["grad_norm"]) > 10 * cfg.clip_norm
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(ref_m["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(ref_m["lr"]),
                                   rtol=1e-6)
    assert int(state["step"]) == int(ref_state["step"]) == 2
    for k in shapes:
        for ours_t, ref_a in ((ours[k], ref_p[k]),
                              (state["mu"][k], ref_state["mu"][k]),
                              (state["nu"][k], ref_state["nu"][k])):
            np.testing.assert_allclose(
                ours_t.float().numpy(), np.asarray(ref_a, np.float32),
                rtol=1e-6, atol=1e-9)


# -------------------------------------------------------------------- loss
def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(5)
    logits = _randn(rng, 2, 9, 50, scale=4.0)
    targets = rng.integers(0, 50, (2, 9)).astype(np.int32)
    for z in (0.0, 1e-4):
        np.testing.assert_allclose(
            float(ts.cross_entropy(_t(logits), _t(targets), z)),
            float(ref_ts.cross_entropy(jnp.asarray(logits),
                                       jnp.asarray(targets), z)),
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chunk", [512, 16])
def test_chunked_cross_entropy_matches_reference(chunk):
    """S = 40 is not a multiple of a 16-token chunk (the last chunk is
    padded with -1 targets), and a few real targets are -1 too."""
    cfg, model = _model("zamba2-1.2b")
    ref_cfg = ref_configs.get_config("zamba2-1.2b").tiny()
    rng = np.random.default_rng(6)
    x = _randn(rng, 2, S, cfg.d_model)
    targets = rng.integers(0, cfg.vocab, (2, S)).astype(np.int32)
    targets[0, :3] = -1
    with torch.no_grad():
        ours = ts.chunked_cross_entropy(cfg, model, _t(x), _t(targets),
                                        1e-4, chunk)
    ref = ref_ts.chunked_cross_entropy(ref_cfg, _ref_params("zamba2-1.2b"),
                                       jnp.asarray(x), jnp.asarray(targets),
                                       1e-4, chunk)
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------- call-site backward
@pytest.mark.parametrize("sq,skv,group", [
    (40, 24, 1), (70, 130, 2), (129, 300, 4), (64, 64, 2)])
def test_flash_backward_across_lengths_matches_reference(sq, skv, group):
    """``_Flash`` without a mask, Sq queries over Skv keys, each padded to
    its tile and the pad keys masked by the bound (``kv_len`` = Skv),
    against ``jax.vjp`` of the reference's ``blockwise_attention``: the
    output and dq, dk, dv (the pad's gradients cut off)."""
    rng = np.random.default_rng(sq + skv)
    b, h, d = 2, 4, 16
    q = _randn(rng, b, sq, h, d)
    k, v = (_randn(rng, b, skv, h // group, d) for _ in range(2))
    dout = _randn(rng, b, sq, h, d)
    ref_out, vjp = jax.vjp(functools.partial(
        ref_attn.blockwise_attention, causal=False, block_kv=16),
        *map(jnp.asarray, (q, k, v)))
    ref_grads = vjp(jnp.asarray(dout))
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    out = attention.blockwise_attention(qt, kt, vt, causal=False)
    grads = torch.autograd.grad(out, (qt, kt, vt), _t(dout))
    assert _rel(out.detach(), ref_out) < GRAD_TOL
    for ours, ref in zip(grads, ref_grads):
        assert ours.shape == ref.shape
        assert _rel(ours, ref) < GRAD_TOL


def test_flash_backward_bf16_dq_cancels_as_the_reference():
    """Why a bf16 dq can stand far from the oracle's: the flash backward's
    delta = sum(dout * out) reads the bf16-rounded output, in the
    reference's custom VJP as in the port's ``_flash_bwd``. Keys and
    values that share a large common component (as whisper's encoder
    output gives its cross-attention) make dq = scale * sum_j p_j (dp_j -
    delta) k_j cancel, and both packages' dq then stand more than bf16's
    RTOL from autograd through their oracle; in float32 both agree with
    it within ``GRAD_TOL``, and dk and dv in either dtype."""
    rng = np.random.default_rng(13)
    b, sq, skv, h, d = 1, 128, 600, 4, 32
    q = _randn(rng, b, sq, h, d, scale=0.5)
    k, v = (_randn(rng, b, skv, h, d) + 3.0 * _randn(rng, b, 1, h, d)
            for _ in range(2))
    dout = _randn(rng, b, sq, h, d)
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        args = [jnp.asarray(x, jdt) for x in (q, k, v)]
        _, vjp = jax.vjp(functools.partial(
            ref_attn.blockwise_attention, causal=False, block_kv=128), *args)
        _, oracle = jax.vjp(functools.partial(
            ref_attn.attention_reference, causal=False), *args)
        ref = [np.asarray(g, np.float32)
               for g in vjp(jnp.asarray(dout, jdt))]
        ref_oracle = [np.asarray(g, np.float32)
                      for g in oracle(jnp.asarray(dout, jdt))]
        leaves = [_t(x).to(dtype).requires_grad_() for x in (q, k, v)]
        out = attention.blockwise_attention(*leaves, causal=False)
        ours = [g.float() for g in torch.autograd.grad(
            out, leaves, _t(dout).to(dtype))]
        plain = attention.attention_reference(*leaves, causal=False)
        oracle_ours = [g.float() for g in torch.autograd.grad(
            plain, leaves, _t(dout).to(dtype))]
        for i, name in enumerate(("dq", "dk", "dv")):
            errs = (_rel(ours[i], oracle_ours[i]),
                    _rel(ref[i], ref_oracle[i]))
            if dtype == torch.bfloat16 and name == "dq":
                assert min(errs) > 2e-2, errs
            else:
                assert max(errs) < (GRAD_TOL if dtype == torch.float32
                                    else 2e-2), (name, errs)


def test_flash_bwd_leaves_the_pad_keys_out():
    """``_flash_bwd`` on kernel-layout tensors with 50 real keys of 64:
    dk and dv of the pad are exactly 0 and the real keys' gradients equal
    those of the unpadded call."""
    rng = np.random.default_rng(3)
    q, dout = (_t(_randn(rng, 4, 64, 16)) for _ in range(2))
    k, v = (_t(_randn(rng, 2, 64, 16)) for _ in range(2))
    out, lse = fa.attention_plain(q, k, v, causal=False, return_lse=True,
                                  kv_len=50)
    dq, dk, dv = attention._flash_bwd(q, k, v, out, lse, dout, causal=False,
                                      window=None, kv_len=50)
    assert not dk[:, 50:].any() and not dv[:, 50:].any()
    out2, lse2 = fa.attention_plain(q, k[:, :50], v[:, :50], causal=False,
                                    return_lse=True)
    want = attention._flash_bwd(q, k[:, :50], v[:, :50], out2, lse2, dout,
                                causal=False, window=None)
    for ours, ref in zip((dq, dk[:, :50], dv[:, :50]), want):
        assert _rel(ours, ref) < 1e-6


@pytest.mark.parametrize("s,group,window", [
    (40, 2, None), (70, 2, 16), (64, 1, None), (129, 4, 8)])
def test_flash_backward_matches_reference(s, group, window):
    """``_Flash`` (here: ``attention_plain``'s forward with its logsumexp,
    the port's ``_flash_bwd``) against ``jax.vjp`` of the reference's
    ``blockwise_attention`` (its custom VJP, 16-key blocks): causal, with
    a window, GQA groups 1, 2 and 4, S not a multiple of the 64-token
    tile (padded and sliced back)."""
    rng = np.random.default_rng(s)
    b, h, d = 2, 4, 16
    q = _randn(rng, b, s, h, d)
    k, v = (_randn(rng, b, s, h // group, d) for _ in range(2))
    dout = _randn(rng, b, s, h, d)
    ref_out, vjp = jax.vjp(functools.partial(
        ref_attn.blockwise_attention, causal=True, window=window,
        block_kv=16), *map(jnp.asarray, (q, k, v)))
    ref_grads = vjp(jnp.asarray(dout))
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    out = attention.blockwise_attention(qt, kt, vt, causal=True,
                                        window=window)
    grads = torch.autograd.grad(out, (qt, kt, vt), _t(dout))
    assert _rel(out.detach(), ref_out) < GRAD_TOL
    for ours, ref in zip(grads, ref_grads):
        assert _rel(ours, ref) < GRAD_TOL


def _ssd_inputs(rng, bsz, s, nh, p, n):
    x = _randn(rng, bsz, s, nh, p)
    dt = np.log1p(np.exp(_randn(rng, bsz, s, nh))) * 0.3
    a = -np.exp(_randn(rng, nh, scale=0.5))
    return (x, dt.astype(np.float32), a.astype(np.float32),
            _randn(rng, bsz, s, n), _randn(rng, bsz, s, n))


@pytest.mark.parametrize("chunks", [1, 3, 6])
def test_ssd_backward_matches_reference(chunks):
    """``_SSDScan`` (here: ``ssd_plain``'s forward with the chunks'
    incoming states, the port's ``_ssd_bwd``) against ``jax.vjp`` of the
    reference's ``_ssd_chunked``, with a gradient on y and on the final
    state: dx, ddt, da, dB, dC."""
    chunk = 8
    rng = np.random.default_rng(chunks)
    args = _ssd_inputs(rng, 2, chunk * chunks, 3, 8, 5)
    dy = _randn(rng, 2, chunk * chunks, 3, 8)
    dh = _randn(rng, 2, 3, 5, 8)
    (ref_y, ref_h), vjp = jax.vjp(
        lambda *a: ref_mamba._ssd_chunked(*a, chunk),
        *map(jnp.asarray, args))
    ref_grads = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    ts_args = [_t(x).requires_grad_() for x in args]
    y, h = mamba2._ssd_chunked(*ts_args, chunk, final_state=True)
    grads = torch.autograd.grad((y, h), ts_args, (_t(dy), _t(dh)))
    assert _rel(y.detach(), ref_y) < GRAD_TOL
    assert _rel(h.detach(), ref_h) < GRAD_TOL
    for ours, ref in zip(grads, ref_grads):
        assert _rel(ours, ref) < GRAD_TOL
    # training asks for no final state: the gradient of y alone
    y, none = mamba2._ssd_chunked(*ts_args, chunk, final_state=False)
    assert none is None
    grads = torch.autograd.grad(y, ts_args, _t(dy))
    for ours, ref in zip(grads, vjp((jnp.asarray(dy),
                                     jnp.zeros_like(ref_h)))):
        assert _rel(ours, ref) < GRAD_TOL


def test_training_asks_the_kernels_for_lse_and_states(monkeypatch):
    """Under autograd the call sites ask the wrappers for the lse and the
    chunks' states (the backward's inputs); under ``no_grad`` (serving)
    they ask for neither."""
    seen = []

    def spy(fn, key):
        def call(*args, **kwargs):
            seen.append((key, bool(kwargs.get(key))))
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(fa, "flash_attention",
                        spy(fa.flash_attention, "return_lse"))
    monkeypatch.setattr(ssd, "ssd_scan", spy(ssd.ssd_scan, "chunk_states"))
    cfg, model = _model("zamba2-1.2b")
    toks = torch.from_numpy(_tokens(cfg)).long()
    tf.forward(cfg, model, {"tokens": toks}).sum().backward()
    sites = cfg.n_layers // cfg.shared_attn_every
    assert sorted(seen) == sorted([("return_lse", True)] * sites
                                  + [("chunk_states", True)] * cfg.n_layers)
    seen.clear()
    with torch.no_grad():
        tf.forward(cfg, model, {"tokens": toks})
    assert sorted(seen) == sorted([("return_lse", False)] * sites
                                  + [("chunk_states", False)] * cfg.n_layers)


# ------------------------------------------------------------ whole models
def test_to_reference_inverts_from_reference():
    for name in ARCHS:
        cfg, model = _model(name)
        back = to_reference(cfg, dict(model.named_parameters()))
        ref = _flat(jax.tree.map(np.asarray, _ref_params(name)))
        ours = _flat(back)
        assert ours.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(ours[k], ref[k])
    with pytest.raises(ValueError, match="names differ"):
        to_reference(cfg, {"embed": model.embed})


# held in float32 only: in bf16 the two packages route some tokens to other
# experts (tests/test_torch_models.py, ``FLOAT32_ONLY``)
FLOAT32_ONLY = {"qwen3-moe-235b-a22b"}


@pytest.fixture(scope="module", params=[
    (a, d) for a in ARCHS for d in MODEL_TOL
    if d == "float32" or a not in FLOAT32_ONLY],
    ids=lambda p: f"{p[0]}-{p[1]}")
def loss_and_grads(request):
    """Both packages' training loss (remat full, chunked CE with z-loss)
    and its gradient by leaf on one seeded batch with its family's
    inputs, in one compute dtype."""
    name, dtype = request.param
    with pytest.MonkeyPatch.context() as mp:
        if dtype == "float32":
            mp.setattr(ref_tf, "COMPUTE_DTYPE", jnp.float32)
            mp.setattr(tf, "COMPUTE_DTYPE", torch.float32)
        cfg, model = _model(name)
        ref_cfg = ref_configs.get_config(name).tiny()
        batch = _batch(cfg)
        tc = ts.TrainConfig()
        ref_loss, ref_grads = jax.jit(jax.value_and_grad(ref_ts.make_loss_fn(
            ref_cfg, ref_ts.TrainConfig())))(
            _ref_params(name), {k: jnp.asarray(v) for k, v in batch.items()})
        loss = ts.make_loss_fn(cfg, tc)(model, {k: _t(v)
                                                for k, v in batch.items()})
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return {"tol": MODEL_TOL[dtype], "loss": (loss.item(),
                                                  float(ref_loss)),
                "grads": (_flat(to_reference(cfg, dict(zip(names, grads)))),
                          _flat(jax.tree.map(np.asarray, ref_grads)))}


def test_model_loss_matches_reference(loss_and_grads):
    ours, ref = loss_and_grads["loss"]
    assert np.isfinite(ours)
    assert abs(ours - ref) <= loss_and_grads["tol"][0] * abs(ref)


def test_model_grads_match_reference(loss_and_grads):
    ours, ref = loss_and_grads["grads"]
    assert ours.keys() == ref.keys()
    errs = {k: _rel(ours[k], ref[k]) for k in ref}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= loss_and_grads["tol"][1], (worst, errs[worst])


@pytest.mark.parametrize("name", ["gemma3-1b", "zamba2-1.2b",
                                  "qwen3-moe-235b-a22b", "whisper-small",
                                  "qwen2-vl-2b"])
def test_train_step_matches_reference(name, monkeypatch):
    """One full train step (remat full, AdamW with clipping) in float32:
    every parameter afterwards, the step's loss and grad norm."""
    monkeypatch.setattr(ref_tf, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(tf, "COMPUTE_DTYPE", torch.float32)
    cfg, model = _model(name)
    ref_cfg = ref_configs.get_config(name).tiny()
    kw = dict(peak_lr=3e-4, warmup_steps=1, total_steps=10)
    opt, ref_opt_cfg = optimizer.OptimizerConfig(**kw), \
        ref_opt.OptimizerConfig(**kw)
    batch = _batch(cfg, seed=2)
    ref_state = {"params": _ref_params(name),
                 "opt": ref_opt.init_opt_state(ref_opt_cfg,
                                               _ref_params(name))}
    ref_state, ref_m = jax.jit(ref_ts.make_train_step(ref_cfg, ref_opt_cfg))(
        ref_state, {k: jnp.asarray(v) for k, v in batch.items()})
    state = {"params": model, "opt": optimizer.init_opt_state(
        opt, dict(model.named_parameters()))}
    state, m = ts.make_train_step(cfg, opt)(state, batch)
    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(ref_m["grad_norm"]), rtol=1e-3)
    ours = _flat(to_reference(cfg, dict(model.named_parameters())))
    ref = _flat(jax.tree.map(np.asarray, ref_state["params"]))
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-5,
                                   atol=STEP_ATOL, err_msg=k)


def _port_loss_grads(name, **tc):
    cfg, model = _model(name)
    batch = _batch(cfg, seed=3, rows=4)
    loss = ts.make_loss_fn(cfg, ts.TrainConfig(**tc))(
        model, {k: _t(v) for k, v in batch.items()})
    return loss.item(), [g.numpy() for g in torch.autograd.grad(
        loss, list(model.parameters()))]


@pytest.mark.parametrize("name", ARCHS)
def test_remat_policies_agree(name):
    """remat none / dots / full give the same loss and gradients (the
    reference's models are held against each other the same way)."""
    base_loss, base = _port_loss_grads(name, remat="none")
    for remat in ("dots", "full"):
        loss, grads = _port_loss_grads(name, remat=remat)
        assert loss == pytest.approx(base_loss, rel=1e-6)
        assert all(_rel(g, b) < 1e-5 for g, b in zip(grads, base))
    with pytest.raises(ValueError, match="remat"):
        _port_loss_grads(name, remat="some")


@pytest.mark.parametrize("name", ["gemma3-1b", "zamba2-1.2b"])
def test_microbatch_equivalence(name):
    """2 microbatches equal 1 (the reference's
    test_training_data.py::test_microbatch_equivalence, for the port):
    the step's loss and the parameters after it."""
    cfg = configs.get_config(name).tiny()
    opt = optimizer.OptimizerConfig(total_steps=10)
    toks = _tokens(cfg, seed=4, rows=4)
    outs = []
    for mb in (1, 2):
        state = ts.init_train_state(cfg, opt, torch.Generator().manual_seed(0),
                                    device="cpu")
        step = ts.make_train_step(cfg, opt, ts.TrainConfig(microbatches=mb,
                                                           remat="none"))
        state, m = step(state, {"tokens": toks})
        outs.append((float(m["loss"]), state["params"].embed.detach()
                     .numpy().copy()))
    assert outs[0][0] == pytest.approx(outs[1][0], rel=1e-5)
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=1e-5,
                               atol=STEP_ATOL)
    with pytest.raises(ValueError, match="microbatches"):
        ts.make_train_step(cfg, opt, ts.TrainConfig(microbatches=3))(
            state, {"tokens": toks})


def test_mu_dtype_bf16_option():
    cfg = configs.get_config("olmo-1b").tiny()
    opt = optimizer.OptimizerConfig(total_steps=10, mu_dtype="bfloat16")
    state = ts.init_train_state(cfg, opt, device="cpu")
    assert state["opt"]["mu"]["embed"].dtype == torch.bfloat16
    assert state["opt"]["nu"]["embed"].dtype == torch.float32
    assert state["opt"]["step"].dtype == torch.int32


def test_training_loss_falls():
    """A few steps of the tiny hybrid on the pipeline's batches: the loss
    is finite and falls."""
    cfg = configs.get_config("zamba2-1.2b").tiny()
    opt = optimizer.OptimizerConfig(peak_lr=3e-3, warmup_steps=2,
                                    total_steps=8)
    state = ts.init_train_state(cfg, opt, device="cpu")
    step = ts.make_train_step(cfg, opt)
    pipe = TokenPipeline(DataConfig(cfg.vocab, 32, 4), cfg)
    losses = [float(step(state, pipe.batch_at(i))[1]["loss"])
              for i in range(8)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


# ----------------------------------------------------------------- launcher
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "whisper-small",
                                  "qwen2-vl-2b"])
def test_train_launcher_takes_every_family(arch, capsys):
    """The pipeline's batches carry each family's inputs to the train
    step: two logged steps with a finite loss, no checkpoint."""
    train_launcher.main(["--device", "cpu", "--arch", arch, "--steps", "2",
                         "--seq-len", "16", "--global-batch", "2",
                         "--log-every", "1"])
    out = capsys.readouterr().out
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.splitlines() if "loss=" in line]
    assert len(losses) == 2 and np.isfinite(losses).all()


def test_train_launcher_runs_and_resumes(tmp_path, capsys):
    argv = ["--device", "cpu", "--arch", "zamba2-1.2b", "--seq-len", "16",
            "--global-batch", "2", "--log-every", "1", "--save-every", "2",
            "--ckpt-dir", str(tmp_path)]
    train_launcher.main(argv + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "step      3 loss=" in out and "final checkpoint at step 3" in out
    train_launcher.main(argv + ["--steps", "5"])
    out = capsys.readouterr().out
    assert out.startswith("resumed from step 3")
    assert "step      4 loss=" in out and "step      3" not in out
    assert sorted(p.name for p in tmp_path.glob("*.npz")) == [
        "ckpt_00000002.npz", "ckpt_00000003.npz", "ckpt_00000004.npz",
        "ckpt_00000005.npz"][-3:]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_launcher.main(["--steps", "1"])
