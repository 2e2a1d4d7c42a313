"""LM model stack of the port (``src/repro/models/``): the dense, ssm and
hybrid families, with prefill through the port's flash-attention and SSD
kernels."""
