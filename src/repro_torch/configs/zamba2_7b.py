"""zamba2-7b [hybrid] — Mamba2 blocks + shared attention blocks. [arXiv:2411.15242]

The shared attention block is instantiated per hybrid slot (un-tied); see
DESIGN.md §6. Every 6th slot is a hybrid (mamba2 + attn) slot.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    source="arXiv:2411.15242",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14_336,
    vocab_size=32_000,
    ssm_state=64,
    attn_every=6,
    act="gelu",
    pipeline_stages=16,
    tensor_parallel=1,
)
