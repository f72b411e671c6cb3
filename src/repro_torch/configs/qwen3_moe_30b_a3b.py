"""qwen3-moe-30b-a3b [moe] — 128 experts, top-8. [hf:Qwen/Qwen3-30B-A3B]

d_ff=768 is the per-expert FFN width per the assignment table.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151_936,
    num_experts=128,
    moe_top_k=8,
    rope_theta=1_000_000.0,
    act="silu",
    pipeline_stages=8,
    tensor_parallel=2,
)
