"""xlstm-125m [ssm] — sLSTM + mLSTM blocks. [arXiv:2405.04517]

12 layers in a 2:1 mLSTM:sLSTM pattern (slot layout (mlstm, slstm, mlstm)
per stage — see DESIGN.md §3). d_ff=0: xLSTM blocks carry their own
up/down projections (expand factor 2).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    source="arXiv:2405.04517",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50_304,
    ssm_state=0,
    ssm_expand=2,
    act="gelu",
    pipeline_stages=4,
    tensor_parallel=4,
)
