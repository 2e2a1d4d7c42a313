"""PyTorch/CUDA port of ``repro`` for an NVIDIA H100.

A package of its own beside ``repro`` (the JAX reference): it imports
``torch``, numpy and scipy, never ``jax`` and nothing of ``repro``. Its
layout mirrors ``repro`` module for module, and each module's docstring
names the reference file it answers to. Kernels are written by hand in
CUDA C++ for ``sm_90a`` (``*/csrc/*.cu``) and built at first use
(``repro_torch.cuda``). Entry points run on the card unless the caller
asks for the CPU.
"""
