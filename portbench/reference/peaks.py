"""The card's published peak rates (NVIDIA H100 SXM5 80 GB data sheet,
dense, no sparsity, at the 700 W power limit)."""

BF16_FLOPS_PER_S = 989.4e12    # tensor cores, bf16 inputs, float32 sums
