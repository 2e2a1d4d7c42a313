"""The port's LM stack (``repro_torch.models``) against the reference's
(``repro.models``) on the CPU, on shared weights: the reference's
parameters (``init_params`` from a JAX key) go into the port through
``models.weights.from_reference``, and inputs are made with numpy from a
seed. On the CPU the port's flash-attention and SSD call sites run their
kernels' plain versions (the wrappers' own dispatch); the card runs the
kernels (tests/test_torch_cuda.py, chip_smoke.py phase 7).

Tolerances:

* Modules, in float32: ``F32_TOL`` = 2e-5 (rtol and atol), float32
  arithmetic in another order; the SSD ``SSD_TOL`` = 2e-4, the
  tolerance tests/test_models.py gives the chunked scan against the
  step-by-step recurrence, since the plain three passes group the chunked
  sums otherwise than the reference's ``lax.scan``.
* Whole models in float32 (both packages' ``COMPUTE_DTYPE`` and
  ``CACHE_DTYPE`` set to float32 for the run): logits within 1e-3, caches
  within a relative Frobenius error of 1e-3. The float32 paths agree to
  about 1e-6; the Mamba conv state is bf16 in both packages even then,
  so a value within float32 noise of a bf16 rounding boundary rounds the
  other way, a step of 2^-8 of itself on a few elements, which moves a
  decode step's logits by up to about 3e-4.
* Whole models in bf16, the served dtype: logits within 0.05, the
  tolerance tests/test_models.py:74 gives the reference's own prefill
  against its own forward; caches within a relative Frobenius error of
  0.06. A bf16 step is 2^-8 (0.4 %) of a value, the two frameworks round
  at different places (XLA keeps fused elementwise chains in float32),
  and that adds up to about a step a layer over these 4-5 layers
  (measured at most 0.032). qwen3-moe-235b-a22b's whole model is held
  in float32 only (``FLOAT32_ONLY`` says why); its MoE module in bf16
  too, at ``MOE_BF16_TOL`` = 2e-2, bf16's RTOL in tests/test_kernels.py
  (a bf16 step is 2^-8 of a value; the products sum in another order).
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
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models import mamba2 as ref_mamba
from repro.models import mlp as ref_mlp
import repro_torch.configs as configs
import repro_torch.models.transformer as tf
from repro_torch.kernels import ssd
from repro_torch.models import attention, layers, mamba2, mlp
from repro_torch.models.weights import from_reference

ARCHS = ["gemma3-1b", "olmo-1b", "mamba2-130m", "zamba2-1.2b",
         "qwen3-moe-235b-a22b", "grok-1-314b", "whisper-small",
         "qwen2-vl-2b"]
F32_TOL = 2e-5
SSD_TOL = 2e-4
MODEL_TOL = {"float32": (1e-3, 1e-3), "bfloat16": (0.05, 0.06)}
MOE_BF16_TOL = 2e-2
B, S_FWD, S_PRE, MAX_LEN = 2, 36, 33, 48


@pytest.fixture(autouse=True, scope="module")
def _evaluate_only():
    """The port's weights are trainable parameters; these tests only
    evaluate, as serving does, so they build no autograd graph."""
    with torch.no_grad():
        yield


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(ours, ref, tol):
    np.testing.assert_allclose(np.asarray(ours, np.float32),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


def _tree(d):
    """numpy copy of a JAX pytree of dicts."""
    return jax.tree.map(np.asarray, d)


def _family_inputs(cfg, b, s, seed=2):
    """The batch entries of ``cfg``'s family beside the tokens, in numpy,
    as tests/test_models.py:20-31 makes them: audio embeddings (normal),
    patch embeddings (normal x 0.02) and M-RoPE positions 0..S-1."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.family == "audio":
        out["audio_embeds"] = _randn(rng, b, cfg.n_audio_frames,
                                     cfg.d_model)
    if cfg.family == "vlm":
        out["patch_embeds"] = _randn(rng, b, cfg.n_patches, cfg.d_model,
                                     scale=0.02)
        out["positions"] = np.ascontiguousarray(np.broadcast_to(
            np.arange(s, dtype=np.int32)[None, :, None], (b, s, 3)))
    return out


def _prefix(batch, s):
    """The batch cut to its first ``s`` tokens (and positions)."""
    out = dict(batch, tokens=batch["tokens"][:, :s])
    if "positions" in out:
        out["positions"] = out["positions"][:, :s]
    return out


@functools.lru_cache(maxsize=None)
def _ref_params(name):
    """The reference's parameters of ``name``'s tiny config, key 0
    (jitted: its eager init takes seconds)."""
    ref_cfg = ref_configs.get_config(name).tiny()
    return jax.jit(ref_tf.init_params, static_argnums=0)(
        ref_cfg, jax.random.PRNGKey(0))


def _params(name):
    """(reference config, port config, reference params, port Model)."""
    params = _ref_params(name)
    cfg = configs.get_config(name).tiny()
    return ref_configs.get_config(name).tiny(), cfg, params, from_reference(
        cfg, _tree(params), device="cpu")


# ------------------------------------------------------------------ configs
def test_configs_equal_reference():
    assert list(configs.ARCHS) == list(ref_configs.ARCHS)
    for name, ref in ref_configs.ARCHS.items():
        ours = configs.get_config(name)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert dataclasses.asdict(ours.tiny()) == \
            dataclasses.asdict(ref.tiny())
        assert ours.param_count() == ref.param_count()
        for shape, ref_shape in zip(configs.SHAPES.values(),
                                    ref_configs.SHAPES.values()):
            assert dataclasses.asdict(shape) == dataclasses.asdict(ref_shape)
            assert configs.cell_supported(ours, shape) == \
                ref_configs.cell_supported(ref, ref_shape)
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm_np"])
def test_norms_match_reference(kind):
    rng = np.random.default_rng(1)
    x, scale = _randn(rng, 3, 5, 64, scale=3.0), _randn(rng, 64)
    if kind == "rmsnorm":
        ref = ref_layers.rmsnorm(jnp.asarray(x), jnp.asarray(scale))
        ours = layers.rmsnorm(_t(x), _t(scale))
    else:
        ref = ref_layers.layernorm_np(jnp.asarray(x))
        ours = layers.layernorm_np(_t(x))
    _close(ours, ref, F32_TOL)


@pytest.mark.parametrize("m_rope", [False, True])
def test_rope_matches_reference(m_rope):
    cfg = dataclasses.replace(configs.get_config("qwen2-vl-2b").tiny(),
                              m_rope=m_rope)
    ref_cfg = dataclasses.replace(ref_configs.get_config("qwen2-vl-2b").tiny(),
                                  m_rope=m_rope)
    rng = np.random.default_rng(2)
    shape = (2, 7, 3) if m_rope else (2, 7)
    pos = rng.integers(0, 500, shape).astype(np.int32)
    x = _randn(rng, 2, 7, 4, cfg.d_head)
    ref_ang = ref_layers.rope_angles(ref_cfg, jnp.asarray(pos))
    ang = layers.rope_angles(cfg, _t(pos))
    _close(ang, ref_ang, F32_TOL)
    _close(layers.apply_rope(_t(x), ang),
           ref_layers.apply_rope(jnp.asarray(x), ref_ang), F32_TOL)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(act):
    cfg = dataclasses.replace(configs.get_config("olmo-1b").tiny(), act=act)
    ref_cfg = dataclasses.replace(ref_configs.get_config("olmo-1b").tiny(),
                                  act=act)
    p = _tree(ref_mlp.make_mlp(ref_cfg, jax.random.PRNGKey(3), 64, 128))
    m = mlp.MLP(cfg, 64, 128, device="cpu")
    assert {n for n, _ in m.named_parameters()} == set(p)
    for name, value in p.items():
        getattr(m, name).copy_(_t(value))
    x = _randn(np.random.default_rng(3), 2, 5, 64)
    _close(m(_t(x)), ref_mlp.apply_mlp(ref_cfg, p, jnp.asarray(x)), F32_TOL)


def _moe_pair(name, seed):
    """The reference's ``make_moe`` parameters of ``name``'s tiny config
    (4 experts, top 2) in the port's ``MoE``."""
    ref_cfg = ref_configs.get_config(name).tiny()
    cfg = configs.get_config(name).tiny()
    p = _tree(ref_mlp.make_moe(ref_cfg, jax.random.PRNGKey(seed)))
    m = mlp.MoE(cfg, device="cpu")
    assert {n for n, _ in m.named_parameters()} == set(p)
    for name_, value in p.items():
        getattr(m, name_).copy_(_t(value))
    return ref_cfg, cfg, p, m


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["qwen3-moe-235b-a22b", "grok-1-314b"])
def test_moe_matches_reference(name, dtype):
    """``MoE`` against ``apply_moe`` on the same inputs in one dtype (both
    packages see the same bf16 x), at the config's capacity factor 1.25,
    where the 80 choices of a 40-token row overflow an expert's 25 slots.
    The router logits are built to tie: its last two columns are equal
    (experts 2 and 3 tie for every token) and 12 tokens a row are zero
    (all four experts tie), so the tie order decides which choices are
    dropped: the lower expert first, as ``jax.lax.top_k``."""
    ref_cfg, cfg, p, m = _moe_pair(name, 11)
    p["router"] = np.array(p["router"])
    p["router"][:, 3] = p["router"][:, 2]
    m.router.copy_(_t(p["router"]))
    rng = np.random.default_rng(11)
    x = _randn(rng, 2, 40, cfg.d_model)
    x[:, ::10] = 0.0
    x[:, 1::10] = 0.0
    x[:, 5::10] = 0.0
    xt = _t(x).to(getattr(torch, dtype))
    ref = ref_mlp.apply_moe(ref_cfg, p, jnp.asarray(x, getattr(jnp, dtype)))
    ours = m(xt)
    assert ours.dtype == xt.dtype
    top_p, top_e, _, keep, cap = m.route(xt)
    assert cap == 25 and not bool(keep.all())         # choices dropped
    assert top_e[:, ::10].tolist() == [[[0, 1]] * 4] * 2  # all four tie
    # bf16 router logits from the same input: bit for bit (float32 ones
    # sum in another order)
    ref_logits = (jnp.asarray(x, getattr(jnp, dtype))
                  @ jnp.asarray(p["router"]).astype(getattr(jnp, dtype)))
    logits = (xt @ m.router.to(xt.dtype)).float().numpy()
    if dtype == "bfloat16":
        assert np.array_equal(logits, np.asarray(ref_logits, np.float32))
    _close(logits, ref_logits, F32_TOL)
    tol = F32_TOL if dtype == "float32" else MOE_BF16_TOL
    _close(ours.float(), np.asarray(ref, np.float32), tol)


def test_moe_top_k_breaks_ties_as_lax_top_k():
    """The stable descending sort's first k against ``jax.lax.top_k`` on
    probabilities with ties at and across the k-th place."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.2, 0.2, 0.2], [0.2, 0.2, 0.4, 0.2],
                      [0.1, 0.2, 0.3, 0.4]], np.float32)
    cfg = dataclasses.replace(configs.get_config("qwen3-moe-235b-a22b")
                              .tiny(), top_k=2, d_model=4)
    m = mlp.MoE(cfg, device="cpu")
    # logits whose softmax is ``probs``: log p on an identity router
    m.router.copy_(torch.eye(4))
    _, top_e, _, _, _ = m.route(torch.from_numpy(np.log(probs))[None])
    _, ref_e = jax.lax.top_k(jnp.asarray(probs), 2)
    assert top_e[0].tolist() == np.asarray(ref_e).tolist() == [
        [0, 1], [1, 2], [0, 1], [2, 0], [3, 2]]


# --------------------------------------------------------------- attention
@pytest.mark.parametrize("s,h,hkv,window", [
    (50, 4, 2, None),     # pads 50 to one 64 tile, GQA 2
    (50, 4, 4, 16),       # window
    (200, 4, 1, None),    # pads 200 to two 128 tiles, GQA 4
    (200, 6, 2, 64),      # GQA 3 and a window across tiles
])
def test_blockwise_attention_matches_reference(s, h, hkv, window):
    rng = np.random.default_rng(s + h + hkv)
    q = _randn(rng, 2, s, h, 16)
    k, v = _randn(rng, 2, s, hkv, 16), _randn(rng, 2, s, hkv, 16)
    ref = jax.jit(functools.partial(
        ref_attn.blockwise_attention, causal=True, window=window,
        block_kv=64))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ours = attention.blockwise_attention(_t(q), _t(k), _t(v), causal=True,
                                         window=window)
    assert ours.shape == (2, s, h, 16)
    _close(ours, ref, F32_TOL)
    _close(attention.attention_reference(_t(q), _t(k), _t(v), window=window),
           ref_attn.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), window=window),
           F32_TOL)


@pytest.mark.parametrize("sq,skv,h,hkv", [
    (50, 50, 4, 2),       # one padded 64 tile each, every query reads 50
    (36, 24, 4, 4),       # whisper tiny's cross-attention
    (200, 1500, 6, 2),    # 2 x 128 queries over 12 x 128 keys, 1500 real
    (130, 60, 4, 1),      # queries padded to 256, keys to 64, GQA 4
])
def test_blockwise_attention_without_a_mask_matches_reference(sq, skv, h,
                                                              hkv):
    """Non-causal attention of Sq queries over Skv keys, each padded to
    its tile; the pad keys are masked (``kv_len``), so the padded call is
    exact."""
    rng = np.random.default_rng(sq + skv)
    q = _randn(rng, 2, sq, h, 16)
    k, v = _randn(rng, 2, skv, hkv, 16), _randn(rng, 2, skv, hkv, 16)
    ref = jax.jit(functools.partial(
        ref_attn.blockwise_attention, causal=False, block_kv=64))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ours = attention.blockwise_attention(_t(q), _t(k), _t(v), causal=False)
    assert ours.shape == (2, sq, h, 16)
    _close(ours, ref, F32_TOL)
    _close(attention.attention_reference(_t(q), _t(k), _t(v), causal=False),
           ref_attn.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=False),
           F32_TOL)


def test_blockwise_attention_refuses_a_mask_across_lengths():
    q, k = torch.zeros(1, 40, 2, 16), torch.zeros(1, 50, 2, 16)
    for kw in ({"causal": True}, {"causal": False, "window": 8}):
        with pytest.raises(ValueError, match="as many queries as keys"):
            attention.blockwise_attention(q, k, k, **kw)


def _attention_pair(name, seed):
    """The reference's ``make_attention`` parameters of ``name``'s tiny
    config in the port's ``Attention``."""
    ref_cfg = ref_configs.get_config(name).tiny()
    cfg = configs.get_config(name).tiny()
    p = _tree(ref_tf.make_attention(ref_cfg, jax.random.PRNGKey(seed)))
    m = tf.Attention(cfg, device="cpu")
    assert {n for n, _ in m.named_parameters()} == set(p)
    for name_, value in p.items():
        getattr(m, name_).copy_(_t(value))
    return ref_cfg, cfg, p, m


@pytest.mark.parametrize("cache_len", [0, 17])
def test_cross_attention_decode_matches_reference(cache_len):
    """One decoder token reading the whole static encoder cache (24
    frames of whisper tiny), no RoPE on q, against the reference's
    ``apply_attention_decode(cross=True, rope=False)``; the cache is not
    written."""
    ref_cfg, cfg, p, m = _attention_pair("whisper-small", 9)
    rng = np.random.default_rng(9)
    x = _randn(rng, 2, 1, cfg.d_model)
    xk, xv = (_randn(rng, 2, cfg.n_audio_frames, cfg.n_kv_heads,
                     cfg.d_head) for _ in range(2))
    ref, _, _ = ref_tf.apply_attention_decode(
        ref_cfg, p, jnp.asarray(x), jnp.asarray(xk), jnp.asarray(xv),
        jnp.int32(cache_len), cross=True, rope=False)
    kc, vc = _t(xk), _t(xv)
    ours = m.decode(_t(x), kc, vc, torch.full((2,), cache_len), rope=False,
                    cross=True)
    _close(ours, ref, F32_TOL)
    assert np.array_equal(kc.numpy(), xk) and np.array_equal(vc.numpy(), xv)


def test_cross_attention_matches_reference_and_refuses_rope():
    """Full-sequence cross-attention (whisper tiny: 6 decoder tokens over
    24 encoder frames, unmasked, no RoPE) against the reference's
    ``apply_attention(kv_src=..., causal=False, rope=False)``, k and v
    too; RoPE together with ``kv_src`` is refused (no model asks for
    it)."""
    ref_cfg, cfg, p, m = _attention_pair("whisper-small", 11)
    rng = np.random.default_rng(11)
    x = _randn(rng, 2, 6, cfg.d_model)
    enc = _randn(rng, 2, cfg.n_audio_frames, cfg.d_model)
    pos = np.tile(np.arange(6), (2, 1))
    ref, (ref_k, ref_v) = ref_tf.apply_attention(
        ref_cfg, p, jnp.asarray(x), jnp.asarray(pos), causal=False,
        rope=False, kv_src=jnp.asarray(enc))
    ours, (k, v) = m(_t(x), torch.as_tensor(pos), causal=False, rope=False,
                     kv_src=_t(enc))
    _close(ours, ref, F32_TOL)
    _close(k, ref_k, F32_TOL)
    _close(v, ref_v, F32_TOL)
    with pytest.raises(ValueError, match="RoPE"):
        m(_t(x), torch.as_tensor(pos), causal=False, rope=True,
          kv_src=_t(enc))


def test_m_rope_decode_matches_reference():
    """qwen2-vl's self-attention decode: the position ``cache_len``
    repeated in the three M-RoPE components, the step's k/v written at
    it."""
    ref_cfg, cfg, p, m = _attention_pair("qwen2-vl-2b", 10)
    rng = np.random.default_rng(10)
    x = _randn(rng, 2, 1, cfg.d_model)
    kc, vc = (_randn(rng, 2, 16, cfg.n_kv_heads, cfg.d_head)
              for _ in range(2))
    ref, ref_k, ref_v = ref_tf.apply_attention_decode(
        ref_cfg, p, jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc),
        jnp.int32(11))
    ours_k, ours_v = _t(kc), _t(vc)
    ours = m.decode(_t(x), ours_k, ours_v, torch.full((2,), 11))
    _close(ours, ref, F32_TOL)
    _close(ours_k, ref_k, F32_TOL)
    _close(ours_v, ref_v, F32_TOL)


@pytest.mark.parametrize("window,cache_len", [(None, 9), (4, 9), (None, 20)])
def test_decode_attention_matches_reference(window, cache_len):
    rng = np.random.default_rng(cache_len)
    q = _randn(rng, 2, 1, 4, 16)
    kc, vc = _randn(rng, 2, 24, 2, 16), _randn(rng, 2, 24, 2, 16)
    ref = ref_attn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                    jnp.asarray(vc), jnp.int32(cache_len),
                                    window=window)
    ours = attention.decode_attention(_t(q), _t(kc), _t(vc), cache_len,
                                      window=window)
    _close(ours, ref, F32_TOL)


# ------------------------------------------------------------------- mamba2
def _ssd_inputs(rng, bsz, s, nh, p, n):
    x = _randn(rng, bsz, s, nh, p)
    dt = 0.1 * np.log1p(np.exp(_randn(rng, bsz, s, nh)))
    a = -np.log1p(np.exp(_randn(rng, nh)))
    return x, dt.astype(np.float32), a.astype(np.float32), \
        _randn(rng, bsz, s, n), _randn(rng, bsz, s, n)


def test_ssd_chunked_y_and_final_state_match_reference():
    """An S of 40 padded to the chunk of 16 as ``apply_mamba`` pads it
    (zero dt: pad steps neither decay nor feed the state)."""
    s, chunk, pad = 40, 16, 8
    x, dt, a, b, c = _ssd_inputs(np.random.default_rng(4), 2, s, 3, 8, 4)
    padded = [np.pad(t, [(0, 0), (0, pad)] + [(0, 0)] * (t.ndim - 2))
              for t in (x, dt, b, c)]
    ref_y, ref_h = jax.jit(functools.partial(
        ref_mamba._ssd_chunked, chunk=chunk))(
        *(jnp.asarray(t) for t in padded[:2]), jnp.asarray(a),
        *(jnp.asarray(t) for t in padded[2:]))
    y, h = mamba2._ssd_chunked(*(_t(t) for t in padded[:2]), _t(a),
                               *(_t(t) for t in padded[2:]), chunk)
    _close(y[:, :s], np.asarray(ref_y)[:, :s], SSD_TOL)
    _close(h, ref_h, SSD_TOL)
    with pytest.raises(ValueError, match="chunk"):
        mamba2._ssd_chunked(_t(x), _t(dt), _t(a), _t(b), _t(c), chunk)


@pytest.mark.parametrize("chunk,l", [(16, 16), (16, 80)])
def test_ssd_scan_final_state_equals_reference_h_final(chunk, l):
    """The wrapper's ``final_state`` output on the CPU (``ssd_plain``), on
    flattened (B·H) rows, against the reference model's ``h_final``; one
    chunk and several."""
    x, dt, a, b, c = _ssd_inputs(np.random.default_rng(l), 2, l, 3, 8, 16)
    _, ref_h = ref_mamba._ssd_chunked(jnp.asarray(x), jnp.asarray(dt),
                                      jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(c), chunk=chunk)
    flat = (_t(x).permute(0, 2, 1, 3).reshape(6, l, 8),
            _t(dt).permute(0, 2, 1).reshape(6, l), _t(a).repeat(2),
            _t(b).repeat_interleave(3, 0), _t(c).repeat_interleave(3, 0))
    y, h = ssd.ssd_scan(*flat, chunk=chunk, final_state=True)
    _close(h.reshape(2, 3, 16, 8), ref_h, SSD_TOL)
    assert torch.equal(y, ssd.ssd_scan(*flat, chunk=chunk))
    y2, h2 = ssd.ssd_plain(*flat, chunk=chunk, final_state=True)
    assert torch.equal(y2, y) and torch.equal(h2, h)


def _mamba_pair(seed=5):
    ref_cfg = ref_configs.get_config("zamba2-1.2b").tiny()
    cfg = configs.get_config("zamba2-1.2b").tiny()
    p = _tree(ref_mamba.make_mamba(ref_cfg, jax.random.PRNGKey(seed)))
    m = mamba2.Mamba(cfg, device="cpu")
    assert {n for n, _ in m.named_parameters()} == set(p)
    for name, value in p.items():
        getattr(m, name).copy_(_t(value))
    return ref_cfg, cfg, p, m


def test_apply_mamba_matches_reference():
    """float32 activations, an S of 21 that is not a chunk multiple: the
    output and the decode cache (conv state in bf16 in both, hence the
    conv state's bf16 tolerance)."""
    ref_cfg, cfg, p, m = _mamba_pair()
    x = _randn(np.random.default_rng(6), 2, 21, cfg.d_model)
    ref_out, (ref_conv, ref_h) = jax.jit(functools.partial(
        ref_mamba.apply_mamba, ref_cfg, return_cache=True))(p, jnp.asarray(x))
    out, (conv, h) = m(_t(x), return_cache=True)
    _close(out, ref_out, SSD_TOL)
    _close(h, ref_h, SSD_TOL)
    assert conv.dtype == torch.bfloat16
    _close(conv.float(), np.asarray(ref_conv, np.float32), 2 ** -8)
    assert m(_t(x))[1] is None


def test_decode_mamba_matches_reference():
    ref_cfg, cfg, p, m = _mamba_pair(seed=7)
    rng = np.random.default_rng(7)
    cache = {"conv": _randn(rng, 2, 3, 160).astype(jnp.bfloat16),
             "ssm": _randn(rng, 2, 4, 16, 32)}
    x = _randn(rng, 2, 1, cfg.d_model)
    ref_out, ref_cache = jax.jit(functools.partial(
        ref_mamba.decode_mamba, ref_cfg))(
        p, {k: jnp.asarray(v) for k, v in cache.items()}, jnp.asarray(x))
    out, conv, ssm = m.decode(_t(cache["conv"].astype(np.float32)).to(
        torch.bfloat16), _t(cache["ssm"]), _t(x))
    _close(out, ref_out, F32_TOL)
    _close(ssm, ref_cache["ssm"], F32_TOL)
    _close(conv.float(), np.asarray(ref_cache["conv"], np.float32), 2 ** -8)


@pytest.mark.parametrize("bsz", [1, 2])
def test_call_sites_hand_the_kernels_contiguous_operands(bsz, monkeypatch):
    """The card's wrappers take contiguous tensors only; the CPU's plain
    versions take any, so the routes' layouts are checked here (at B = 1
    a reshape of an expanded tensor is a view)."""
    from repro_torch.kernels import flash_attention as fa
    seen = []

    def contiguous_only(fn):
        def call(*args, **kwargs):
            seen.append(all(t.is_contiguous() for t in args))
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(fa, "flash_attention",
                        contiguous_only(fa.flash_attention))
    monkeypatch.setattr(ssd, "ssd_scan", contiguous_only(ssd.ssd_scan))
    x, dt, a, b, c = _ssd_inputs(np.random.default_rng(bsz), bsz, 32, 3,
                                 8, 4)
    mamba2._ssd_chunked(_t(x), _t(dt), _t(a), _t(b), _t(c), 16)
    q = torch.zeros(bsz, 50, 4, 16)
    attention.blockwise_attention(q, q[:, :, :2], q[:, :, :2])
    assert seen == [True, True]


# ------------------------------------------------------------ whole models
def _leaves(cache, prefix=()):
    """A copy of each cache leaf in float32 (the port's decode steps write
    into its cache)."""
    if isinstance(cache, dict):
        out = {}
        for key, value in cache.items():
            out.update(_leaves(value, prefix + (key,)))
        return out
    if isinstance(cache, torch.Tensor):
        cache = cache.float()
    return {prefix: np.array(cache, np.float32)}


# A whole model held in float32 only. qwen3-moe-235b-a22b in bf16 routes
# tokens differently in the two packages: the attention output entering a
# layer's MoE differs by bf16 rounding (XLA keeps fused elementwise chains
# in float32, PyTorch rounds each op), which moves a router logit by a
# bf16 ulp or two, and where a token's second and third experts are that
# close its second choice flips (layer 1, row 1, token 12: experts 1 and 2
# at logits 0.0542 and 0.0537 in the reference, 0.0527 and 0.0537 in the
# port), so that token's whole expert output differs. Given the same bf16
# input, the two routers' logits are bit-identical
# (``test_moe_matches_reference``, which holds the MoE in bf16).
FLOAT32_ONLY = {"qwen3-moe-235b-a22b"}


@pytest.fixture(scope="module", params=[
    (a, d) for a in ARCHS for d in MODEL_TOL
    if d == "float32" or a not in FLOAT32_ONLY],
    ids=lambda p: f"{p[0]}-{p[1]}")
def run(request):
    """Both packages' forward, prefill (cache and last logits) and three
    decode steps on one seeded batch with its family's inputs, in one
    compute dtype. MoE runs with capacity factor 8 (dropless), as the
    reference's tests/test_models.py:63-64 does, so that prefill and
    decode see the tokens forward sees (``test_moe_matches_reference``
    and ``test_moe_model_matches_reference_with_drops`` drop)."""
    name, dtype = request.param
    with pytest.MonkeyPatch.context() as mp:
        if dtype == "float32":
            for mod, dt in ((ref_tf, jnp.float32), (tf, torch.float32)):
                mp.setattr(mod, "COMPUTE_DTYPE", dt)
                mp.setattr(mod, "CACHE_DTYPE", dt)
        ref_cfg, cfg, params, model = _params(name)
        if cfg.family == "moe":
            ref_cfg, cfg = (dataclasses.replace(c, capacity_factor=8.0)
                            for c in (ref_cfg, cfg))
            model = from_reference(cfg, _tree(params), device="cpu")
        toks = np.random.default_rng(1).integers(
            0, cfg.vocab, (B, S_FWD)).astype(np.int32)
        batch = {"tokens": toks, **_family_inputs(cfg, B, S_FWD)}
        # fresh jit wrappers: their traces read the patched dtypes
        ref_fns = (jax.jit(functools.partial(ref_tf.forward, ref_cfg)),
                   jax.jit(functools.partial(ref_tf.prefill, ref_cfg),
                           static_argnames="max_len"),
                   jax.jit(functools.partial(ref_tf.decode_step, ref_cfg)))
        our_fns = (functools.partial(fn, cfg) for fn in
                   (tf.forward, tf.prefill, tf.decode_step))
        out = {"tol": MODEL_TOL[dtype]}
        for side, ((forward, prefill, decode_step), p, conv) in {
                "ref": (ref_fns, params, jnp.asarray),
                "ours": (our_fns, model, _t)}.items():
            logits = forward(p, {k: conv(v) for k, v in batch.items()})
            last, cache, clen = prefill(
                p, {k: conv(v) for k, v in _prefix(batch, S_PRE).items()},
                max_len=MAX_LEN)
            out[side] = {"forward": np.asarray(logits), "last":
                         np.asarray(last), "cache": _leaves(cache)}
            for i in range(S_FWD - S_PRE):
                step, cache = decode_step(
                    p, cache, conv(toks[:, S_PRE + i:S_PRE + i + 1]),
                    clen + i)
                out[side][f"decode{i}"] = np.asarray(step)
        return out


@pytest.mark.parametrize("what", ["forward", "last", "decode0", "decode1",
                                  "decode2"])
def test_model_logits_match_reference(run, what):
    atol = run["tol"][0]
    ref, ours = run["ref"][what], run["ours"][what]
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=atol)


def test_prefill_cache_matches_reference(run):
    ref, ours = run["ref"]["cache"], run["ours"]["cache"]
    assert set(ours) == set(ref)
    for key, value in ref.items():
        assert ours[key].shape == value.shape, key
        err = np.linalg.norm(ours[key] - value) / np.linalg.norm(value)
        assert err <= run["tol"][1], (key, err)


def test_prefill_and_decode_match_forward(run):
    """The port's own serving paths against its forward, with the
    reference's tolerances (tests/test_models.py:73-79)."""
    ours = run["ours"]
    full = ours["forward"]
    assert np.abs(ours["last"] - full[:, S_PRE - 1]).max() < 0.05
    for i in range(S_FWD - S_PRE):
        scale = float(np.std(full[:, S_PRE + i])) + 1e-6
        assert np.abs(ours[f"decode{i}"] - full[:, S_PRE + i]).max() \
            / scale < 0.3


@pytest.mark.parametrize("name", ["qwen3-moe-235b-a22b", "grok-1-314b"])
def test_moe_model_matches_reference_with_drops(name, monkeypatch):
    """A whole MoE model at the config's capacity factor 1.25, in float32:
    forward's logits within 1e-3 of the reference's, with choices dropped
    by capacity in some layer (counted through the port's ``route``)."""
    for mod, dt in ((ref_tf, jnp.float32), (tf, torch.float32)):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", dt)
    ref_cfg, cfg, params, model = _params(name)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (B, S_FWD))
    dropped = []
    for blk in model.layers:
        blk.moe.register_forward_hook(lambda mod, args, out: dropped.append(
            int((~mod.route(args[0])[3]).sum())))
    ours = tf.forward(cfg, model, {"tokens": _t(toks).long()})
    ref = jax.jit(functools.partial(ref_tf.forward, ref_cfg))(
        params, {"tokens": jnp.asarray(toks, jnp.int32)})
    assert len(dropped) == cfg.n_layers and sum(dropped) > 0
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=MODEL_TOL["float32"][0])


# ------------------------------------------------------------ params, guards
def test_from_reference_refuses_a_tree_that_does_not_fit():
    cfg = configs.get_config("olmo-1b").tiny()
    tree = _tree(_ref_params("olmo-1b"))
    tree["layers"]["mlp"]["wi"] = tree["layers"]["mlp"]["wi"][:, :, :64]
    with pytest.raises(ValueError, match="wi"):
        from_reference(cfg, tree, device="cpu")
    tree = _tree(_ref_params("olmo-1b"))
    tree["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="extra"):
        from_reference(cfg, tree, device="cpu")


def test_init_params_draws_from_its_generator():
    cfg = configs.get_config("zamba2-1.2b").tiny()
    a, b, c = (tf.init_params(cfg, torch.Generator().manual_seed(s),
                              device="cpu") for s in (3, 3, 4))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["mamba_groups.0.0.mamba.in_proj"],
                           sc["mamba_groups.0.0.mamba.in_proj"])
    n_ref = sum(x.size for x in jax.tree.leaves(_ref_params("zamba2-1.2b")))
    assert sum(p.numel() for p in a.parameters()) == n_ref
    assert all(p.requires_grad for p in a.parameters())  # trainable
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tf.init_params(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tf.init_cache(cfg, 1, 8)
