"""Published peaks of one NVIDIA H100 SXM5 80 GB, frozen for the benchmark.

Frozen copy of the constants of ``src/repro_torch/launch/analysis.py`` at
commit 050b402: NVIDIA's data-sheet rates, dense, without sparsity, at the
card's full 700 W power limit. They are not measurements: a card set
below 700 W (``nvidia-smi``'s ``power.limit``) runs slower under load,
and every share of a peak is stated with the card's limit beside it.
"""
PEAK_FLOPS_BF16 = 989.4e12      # dense bf16 on the tensor cores, FLOP/s
PEAK_FLOPS_TF32 = 494.7e12      # dense tf32 on the tensor cores, FLOP/s
PEAK_FLOPS_F32 = 66.9e12        # f32 outside the tensor cores, FLOP/s
HBM_BYTES_PER_S = 3.35e12       # HBM3, bytes/s
