"""whisper-base [audio] — enc-dec transformer backbone; conv/mel frontend is a
stub (input_specs provides precomputed frame embeddings). [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    source="arXiv:2212.04356",
    num_layers=12,              # 6 enc + 6 dec
    encoder_layers=6,
    decoder_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51_865,
    max_target_positions=448,
    frontend="audio_frames",
    num_audio_frames=1500,      # 30 s audio -> 1500 post-conv frames
    rope_theta=0.0,             # whisper uses learned/sinusoidal positions, not RoPE
    act="gelu",
    pipeline_stages=2,
    tensor_parallel=8,
)
