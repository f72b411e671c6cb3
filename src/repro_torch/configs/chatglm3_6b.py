"""chatglm3-6b [dense] — GQA kv=2, 2d RoPE (rotary on half the head dims).
[arXiv:2406.12793]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    source="arXiv:2406.12793",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13_696,
    vocab_size=65_024,
    rope_fraction=0.5,
    rope_theta=10_000.0,
    qkv_bias=True,
    act="silu",
    pipeline_stages=4,
    tensor_parallel=4,
)
