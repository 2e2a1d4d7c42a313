"""The port's serving path (``repro_torch.inference``, ``launch.serve``, the
``serving`` shim) on the CPU, against the reference's engine on shared
weights (``models.weights.from_reference``).

Greedy tokens are compared for equality with both packages computing in
float32 (their ``COMPUTE_DTYPE`` and ``CACHE_DTYPE`` set to float32 for
the run; tests/test_torch_models.py holds the two models within 1e-3
there). In bf16, the served dtype, the frameworks round at different
places and the logits differ by up to about 0.02 (tests/test_torch_models.py),
so any pair of top logits closer than that may pick either token; equal
tokens say something only where the logits agree far below the margins.
Sampled tokens cannot match JAX's draws (the port's noise comes from a
``torch.Generator``): they are held for shape, range and determinism
under a seed.
"""
import dataclasses
import importlib
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.transformer as ref_tf
from repro.inference.engine import Request as RefRequest
from repro.inference.engine import ServingEngine as RefEngine
import repro_torch.configs as configs
import repro_torch.models.transformer as tf
from repro_torch.deprecations import ServingMovedWarning
from repro_torch.inference import engine as inference
from repro_torch.inference.engine import Request, ServingEngine
from repro_torch.launch import serve
from repro_torch.models.weights import from_reference

ARCHS = ["gemma3-1b", "olmo-1b", "mamba2-130m", "zamba2-1.2b",
         "qwen3-moe-235b-a22b", "grok-1-314b", "whisper-small",
         "qwen2-vl-2b"]


@pytest.fixture(autouse=True, scope="module")
def _evaluate_only():
    """The port's weights are trainable parameters; these tests only
    evaluate, as serving does, so they build no autograd graph."""
    with torch.no_grad():
        yield


def _model(name: str):
    cfg = configs.get_config(name).tiny()
    return cfg, tf.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")


@pytest.mark.parametrize("name", ARCHS)
def test_greedy_tokens_equal_reference(name, monkeypatch):
    """Three requests, one shorter (both engines left-align it and pad
    with token 0), 8 new tokens each; each engine builds its family's
    inputs (zero audio or patch embeddings, M-RoPE positions)."""
    for mod, dt in ((ref_tf, jnp.float32), (tf, torch.float32)):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", dt)
        monkeypatch.setattr(mod, "CACHE_DTYPE", dt)
    ref_cfg = ref_configs.get_config(name).tiny()
    cfg = configs.get_config(name).tiny()
    params = jax.jit(ref_tf.init_params, static_argnums=0)(
        ref_cfg, jax.random.PRNGKey(0))
    model = from_reference(cfg, jax.tree.map(np.asarray, params),
                           device="cpu")
    prompts = np.random.default_rng(2).integers(0, cfg.vocab,
                                                (3, 12)).tolist()
    prompts[1] = prompts[1][:9]
    ref = RefEngine(ref_cfg, params, max_len=24).generate(
        [RefRequest(p, 8) for p in prompts])
    engine = ServingEngine(cfg, model, max_len=24)
    ours = engine.generate([Request(p, 8) for p in prompts])
    assert ours == ref
    assert engine.timings["steps"] == 8
    assert engine.timings["prefill_ms"] > 0 and engine.timings["decode_ms"] > 0


def test_sampling_is_deterministic_under_a_seed():
    cfg, model = _model("zamba2-1.2b")
    reqs = [Request([5, 6, 7, 8], 6, temperature=1.0) for _ in range(2)]
    engine = ServingEngine(cfg, model, max_len=16)
    a, b = (engine.generate(reqs, torch.Generator().manual_seed(3))
            for _ in range(2))
    assert a == b
    assert [len(o) for o in a] == [6, 6]
    assert all(0 <= t < cfg.vocab for o in a for t in o)
    assert engine.generate(reqs, torch.Generator().manual_seed(4)) != a
    # without a generator, one seeded 0 each call (the reference's PRNGKey(0))
    assert engine.generate(reqs) == engine.generate(
        reqs, torch.Generator().manual_seed(0))
    greedy = [Request([5, 6, 7, 8], 6)] * 2
    assert engine.generate(greedy) == engine.generate(greedy)


def test_generate_refuses_what_does_not_fit_max_len():
    cfg, model = _model("olmo-1b")
    engine = ServingEngine(cfg, model, max_len=10)
    with pytest.raises(ValueError, match="max_len"):
        engine.generate([Request(list(range(8)), 3)])
    assert engine.generate([Request(list(range(8)), 0)]) == [[]]
    assert len(engine.generate([Request(list(range(8)), 2)])[0]) == 2


def test_decode_fn_is_the_decode_step():
    cfg, model = _model("mamba2-130m")
    toks = torch.tensor([[1, 2, 3, 4]] * 2)
    _, cache, n = tf.prefill(cfg, model, {"tokens": toks}, 8)
    step = inference.make_decode_fn(cfg)
    a, _ = step(model, {k: v.clone() for k, v in cache.items()},
                toks[:, :1], n)
    b, _ = tf.decode_step(cfg, model, cache, toks[:, :1], n)
    assert torch.equal(a, b)


def test_serve_launcher_runs_on_the_cpu(capsys):
    serve.main(["--device", "cpu", "--preset", "tiny", "--arch",
                "zamba2-1.2b", "--batch", "2", "--prompt-len", "6",
                "--new-tokens", "3", "--max-len", "16"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "arch=zamba2-1.2b-tiny batch=2 prompt=6 new=3"
    assert out[1].startswith("  req0: [") and out[2].startswith("  req1: [")
    assert out[3].startswith("generated 6 tokens in ")
    assert out[4].startswith("on cpu: prefill ") and "3 steps" in out[4]


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "whisper-small",
                                  "qwen2-vl-2b"])
def test_serve_launcher_serves_every_family(capsys, arch):
    """A prompt of 9 tokens: qwen2-vl's 8 patch embeddings replace the
    first 8 token embeddings."""
    serve.main(["--device", "cpu", "--preset", "tiny", "--arch", arch,
                "--batch", "2", "--prompt-len", "9", "--new-tokens", "3",
                "--max-len", "16"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"arch={arch}-tiny batch=2 prompt=9 new=3"
    assert out[3].startswith("generated 6 tokens in ")
    assert out[4].startswith("on cpu: prefill ") and "3 steps" in out[4]


def test_serve_raises_without_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--new-tokens", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.init_params(configs.get_config("olmo-1b").tiny())


def test_serving_shim_warns_with_the_ports_class():
    from repro.deprecations import ServingMovedWarning as RefWarning
    assert not issubclass(ServingMovedWarning, RefWarning)
    for mod in ("repro_torch.serving.engine", "repro_torch.serving"):
        sys.modules.pop(mod, None)
    with pytest.warns(ServingMovedWarning, match="repro_torch.inference"):
        shim = importlib.import_module("repro_torch.serving.engine")
    assert shim.ServingEngine is ServingEngine
    assert shim.Request is Request
    assert shim.make_decode_fn is inference.make_decode_fn
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        importlib.import_module("repro_torch.inference.engine")


@pytest.mark.parametrize("name", ["whisper-small", "qwen2-vl-2b",
                                  "olmo-1b"])
def test_family_inputs_match_reference_engine(name):
    """The batch entries ``generate`` adds beside the tokens: zero audio
    embeddings (B, frames, d) float32; zero patch embeddings (B, patches,
    d) and positions (B, S, 3) 0..S-1; nothing for a text-only family."""
    cfg = configs.get_config(name).tiny()
    got = inference.family_inputs(cfg, 3, 10, "cpu")
    want = {"audio": {"audio_embeds": (3, cfg.n_audio_frames, cfg.d_model)},
            "vlm": {"patch_embeds": (3, cfg.n_patches, cfg.d_model),
                    "positions": (3, 10, 3)}}.get(cfg.family, {})
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    for key, value in got.items():
        if key == "positions":
            assert torch.equal(value, torch.arange(10)[None, :, None]
                               .expand(3, 10, 3))
        else:
            assert value.dtype == torch.float32 and not value.any()


def test_request_defaults_match_reference():
    assert [(f.name, f.default) for f in dataclasses.fields(Request)] == \
        [(f.name, f.default) for f in dataclasses.fields(RefRequest)]
