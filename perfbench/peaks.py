"""Published peaks of one NVIDIA H100 SXM (NVIDIA's datasheet, dense, at
the full 700 W power limit). A run prints the card's power limit beside
every share of a peak."""

BYTES_PER_S = 3.35e12     # HBM3
F32_PER_S = 67e12         # float32 outside the tensor cores
BF16_PER_S = 989e12       # bfloat16 operands on the tensor cores
