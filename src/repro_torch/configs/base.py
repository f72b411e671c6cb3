"""Model/run configuration dataclasses.

Every assigned architecture gets a ``ModelConfig`` in ``configs/<id>.py``;
the values are exact per the assignment table (source cited per file).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    source: str = ""               # citation (arXiv id / hf model card)

    # transformer dims
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0              # 0 -> d_model // num_heads
    d_ff: int = 0
    vocab_size: int = 0

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0     # chatglm3 "2d rope": rotate only this fraction of dims
    sliding_window: int = 0        # 0 = full attention
    use_flash_attention: int = 0   # route self-attention through the Pallas
    #                                kernel (interpret on CPU; Mosaic on TPU)
    prefill_seq_chunks: int = 0    # >1: chunked-sequence pipelined prefill
    norm_eps: float = 1e-5
    act: str = "silu"

    # MoE
    num_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # SSM (mamba2 / xlstm)
    ssm_state: int = 0
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    attn_every: int = 0            # hybrid: a shared-attn slot every k-th slot

    # enc-dec (whisper)
    encoder_layers: int = 0
    decoder_layers: int = 0
    max_target_positions: int = 0  # whisper decoder positional budget

    # modality frontend stub
    frontend: str = "none"         # none | audio_frames | vision_patches
    num_prefix_tokens: int = 0     # VLM: anyres patch tokens prepended
    num_audio_frames: int = 0      # whisper: encoder frame count (post-conv)

    # numerics
    dtype: str = "bfloat16"        # activation/compute dtype
    param_dtype: str = "float32"

    # pipeline factorization of the 16-wide `model` mesh axis
    # (stage x tensor x extra_data == 16; extra_data folds leftover model-
    # axis width into data parallelism — a beyond-paper optimization for
    # small models, see EXPERIMENTS.md §Perf)
    pipeline_stages: int = 4
    tensor_parallel: int = 4
    extra_data: int = 1
    layers_per_stage: int = 0      # 0 -> ceil(L / S)
    slot_layout: tuple[str, ...] = ()   # per-stage slot types; () -> family default

    # paper-technique knobs (FTPipeHD)
    stash_depth: int = 2           # weight-version ring (PipeDream-2BW style)
    aggregate_every: int = 0       # 0 -> disabled; else aggregate stash every k steps
    chain_replicate_every: int = 50
    global_replicate_every: int = 100
    repartition_every: int = 100
    repartition_first_at: int = 10

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if not self.slot_layout:
            object.__setattr__(self, "slot_layout", self._default_layout())
        if self.layers_per_stage == 0 and self.slot_layout:
            object.__setattr__(self, "layers_per_stage", len(self.slot_layout))

    # -- derived --------------------------------------------------------
    def _default_layout(self) -> tuple[str, ...]:
        S = self.pipeline_stages
        lps = self.layers_per_stage or -(-self.num_layers // S)
        if self.family == "dense" or self.family == "vlm":
            return ("dense",) * lps
        if self.family == "moe":
            return ("moe",) * lps
        if self.family == "hybrid":
            k = self.attn_every or 6
            return tuple("hybrid" if i % k == 0 else "mamba" for i in range(lps))
        if self.family == "ssm":
            # 2:1 mLSTM:sLSTM pattern, uniform per stage (see DESIGN.md §3)
            return tuple("slstm" if i % 3 == 1 else "mlstm" for i in range(lps))
        if self.family == "audio":
            lps_e = self.layers_per_stage or -(-self.encoder_layers // S)
            return ("enc",) * lps_e        # decoder phase layout derived separately
        raise ValueError(self.family)

    @property
    def decoder_slot_layout(self) -> tuple[str, ...]:
        assert self.family == "audio"
        lps = -(-self.decoder_layers // self.pipeline_stages)
        return ("dec",) * lps

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a 128 multiple (Megatron-style padding) so the
        embedding/head shard evenly over the 16-wide model axis. The loss and
        decode head mask the pad columns."""
        return -(-self.vocab_size // 128) * 128

    @property
    def kv_heads_per_shard(self) -> int:
        return max(1, self.num_kv_heads // self.tensor_parallel)

    @property
    def q_heads_per_shard(self) -> int:
        assert self.num_heads % self.tensor_parallel == 0, (
            f"{self.name}: heads {self.num_heads} % tp {self.tensor_parallel}")
        return self.num_heads // self.tensor_parallel

    def total_slots(self) -> int:
        return self.pipeline_stages * self.layers_per_stage

    def with_overrides(self, **kw) -> "ModelConfig":
        if ("pipeline_stages" in kw or "num_layers" in kw) \
                and "slot_layout" not in kw:
            kw.setdefault("slot_layout", ())
            kw.setdefault("layers_per_stage", 0)
        return dataclasses.replace(self, **kw)

    def reduced(self, **kw) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        small = dict(
            num_layers=4,
            d_model=min(self.d_model, 128),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=32,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            moe_top_k=min(self.moe_top_k, 2) if self.moe_top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            decoder_layers=2 if self.decoder_layers else 0,
            num_prefix_tokens=min(self.num_prefix_tokens, 8) if self.num_prefix_tokens else 0,
            num_audio_frames=min(self.num_audio_frames, 16) if self.num_audio_frames else 0,
            pipeline_stages=2,
            tensor_parallel=1,
            layers_per_stage=0,
            slot_layout=(),
            dtype="float32",
        )
        small.update(kw)
        return dataclasses.replace(self, **small)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 4e-5     # paper §IV-B
    optimizer: str = "sgd"         # sgd | adam
    microbatches: int = 0          # 0 -> num pipeline stages
    remat: bool = True
    bf16_grads: bool = False       # halve the DP all-reduce payload
    seed: int = 0
