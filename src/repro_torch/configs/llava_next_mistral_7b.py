"""llava-next-mistral-7b [vlm] — mistral backbone + anyres patch tokens.
Vision encoder/projector is a stub: input_specs supplies precomputed patch
embeddings (anyres tiling -> 2880 prefix tokens). [hf:llava-hf/llava-v1.6-mistral-7b-hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=32_000,
    rope_theta=1_000_000.0,
    frontend="vision_patches",
    num_prefix_tokens=2880,     # anyres: 5 tiles x 576 patches
    act="silu",
    pipeline_stages=8,
    tensor_parallel=2,
)
