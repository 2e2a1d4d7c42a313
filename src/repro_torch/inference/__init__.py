"""LLM token inference (batched prefill + decode serving engine).

Port of ``src/repro/inference/``. As in the reference, ``serving`` is the
old name, kept as a deprecation shim (``repro_torch.serving``).
"""
