"""qwen2-1.5b [dense] — GQA, QKV bias. [arXiv:2407.10671]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    source="arXiv:2407.10671",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151_936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    act="silu",
    pipeline_stages=4,
    tensor_parallel=4,
)
