"""Card probe of the ``hybrid_moe`` family's held-expert MoE: the prefill's
grouped products as a loop over the held experts against
``torch._grouped_mm`` (the program's) over the same grouped rows, at
granite-4.0-h-small-ep8's widths and the cell's 4 x 8,192 tokens, each
timed by CUDA events and checked against the other; the whole MoE
layer, prefill and decode forms; and, with ``--serve``, the whole model
served at the cell's shapes, each call's prefill and decode by the
engine's CUDA events.

    python3 scripts/probe_hybrid_moe.py [--reps 10] [--serve 3]

Prints one line a measurement and, last, a JSON summary."""
import argparse
import json
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import hybrid_moe  # noqa: E402
from repro_torch.models.layers import activation  # noqa: E402


def timed(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def grouped_rows(moe, z):
    """The prefill's routed rows, grouped by held expert, and the groups'
    sizes, as ``HeldMoE._grouped`` makes them."""
    cfg = moe.cfg
    flat = z.reshape(-1, z.shape[-1])
    top_p, local, held = moe.route(flat)
    e = cfg.n_experts
    key = torch.where(held, local, e).reshape(-1)
    order = torch.argsort(key, stable=True)
    sizes = torch.bincount(key, minlength=e + 1)[:e].tolist()
    tok = order[:sum(sizes)] // cfg.top_k
    return flat[tok], sizes


def loop_products(moe, rows, sizes):
    wi, wg, wo = moe._weights(rows.dtype)
    out = torch.empty_like(rows)
    start = 0
    for j, size in enumerate(sizes):
        r = rows[start:start + size]
        out[start:start + size] = activation(moe.cfg, r @ wg[j],
                                             r @ wi[j]) @ wo[j]
        start += size
    return out


def grouped_mm_products(moe, rows, offs, layout):
    wi, wg, wo = moe._weights(rows.dtype)
    if layout == "column-major":
        wi, wg, wo = (w.transpose(-2, -1).contiguous().transpose(-2, -1)
                      for w in (wi, wg, wo))
    up = torch._grouped_mm(rows, wi, offs=offs)
    gate = torch._grouped_mm(rows, wg, offs=offs)
    return torch._grouped_mm(activation(moe.cfg, gate, up), wo, offs=offs)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--serve", type=int, default=0,
                   help="calls of the whole model at the cell's shapes")
    args = p.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    cfg = get_config("granite-4.0-h-small-ep8")
    gen = torch.Generator(device="cuda").manual_seed(38)
    moe = hybrid_moe.HeldMoE(cfg, gen, "cuda").requires_grad_(False)
    z = torch.randn((4, 8192, cfg.d_model), generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    out = {"card": smi, "torch": torch.__version__}
    with torch.inference_mode():
        rows, sizes = grouped_rows(moe, z)
        out["sizes"] = sizes
        print(f"held rows {sum(sizes)} of {z.shape[0] * z.shape[1]} tokens "
              f"({sum(sizes) / (z.shape[0] * z.shape[1]):.4f} a token); "
              f"by expert {sizes}")
        ms, ref = timed(lambda: loop_products(moe, rows, sizes), args.reps)
        out["loop_ms"] = ms
        print(f"loop over the held experts: {ms:.4f} ms")
        offs = torch.cumsum(torch.tensor(sizes, device="cuda"), 0,
                            dtype=torch.int32)
        for layout in ("row-major", "column-major"):
            try:
                ms, got = timed(lambda: grouped_mm_products(
                    moe, rows, offs, layout), args.reps)
            except Exception as exc:   # noqa: BLE001 - a probe reports it
                print(f"torch._grouped_mm ({layout}): refused: {exc}")
                out[f"grouped_mm_{layout}"] = str(exc)[:200]
                continue
            err = float((got.float() - ref.float()).abs().max()
                        / ref.float().abs().max())
            out[f"grouped_mm_{layout}_ms"] = ms
            out[f"grouped_mm_{layout}_rel_err"] = err
            print(f"torch._grouped_mm ({layout}): {ms:.4f} ms, "
                  f"max error {err:.3e} of the loop's largest")
        for form, per_token, x in (("prefill", False, z),
                                   ("decode", True, z[:, :1])):
            ms, _ = timed(lambda: moe(x, per_token), args.reps)
            out[f"layer_{form}_ms"] = ms
            print(f"HeldMoE {form} form at {tuple(x.shape)}: {ms:.4f} ms")
    del moe, z, rows
    if args.serve:
        out["serve"] = serve(cfg, args.serve)
    print(json.dumps(out))


def serve(cfg, calls):
    """``calls`` greedy calls of 4 x 8,192 random ids, 16 new tokens."""
    from repro_torch.inference.engine import Request, ServingEngine
    from repro_torch.models.transformer import init_params
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(1),
                        device="cuda")
    engine = ServingEngine(cfg, model, max_len=8192 + 16)
    gen = torch.Generator().manual_seed(2)
    got = []
    for i in range(calls + 1):
        ids = torch.randint(0, cfg.vocab, (4, 8192), generator=gen)
        engine.generate([Request(prompt=r, max_new_tokens=16)
                         for r in ids.tolist()])
        t = engine.timings
        print(f"call {i}{' (warm-up)' if i == 0 else ''}: prefill "
              f"{t['prefill_ms']:.1f} ms, decode {t['decode_ms']:.1f} ms "
              f"({t['steps']} steps)")
        if i:
            got.append([t["prefill_ms"], t["decode_ms"]])
    print(f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return got


if __name__ == "__main__":
    main()
