"""Roofline terms, model FLOPs and parameter counts (DESIGN.md §8).

The port of ``repro.launch.analysis``. ``model_flops``, the parameter
counts, ``roofline_terms`` and ``dominant`` are the JAX package's
arithmetic with only their imports changed.

Hardware constants: one NVIDIA H100 SXM5 80 GB at its 700 W power limit,
the card every figure in ``PERF.md`` was taken on. They are NVIDIA's
data-sheet peaks (dense, without sparsity), not measurements: a card set
below 700 W (``nvidia-smi``'s ``power.limit``) runs slower under load.

Not ported, having no meaning without XLA: ``collective_bytes`` and
``_shape_bytes``, which parse the collectives out of compiled HLO text.
The port's collectives are ``torch.distributed`` calls
(``repro_torch.collectives``), not HLO; the bytes a mesh of devices
moves come from ``cost_model.collective_bytes_per_device``.
"""
from __future__ import annotations

PEAK_FLOPS = 989.4e12           # dense bf16 on the tensor cores
PEAK_FLOPS_TF32 = 494.7e12      # dense tf32 on the tensor cores
PEAK_FLOPS_F32 = 66.9e12        # f32 outside the tensor cores
HBM_BW = 3.35e12                # HBM3, bytes/s
NVLINK_BW = 450e9               # NVLink 4, bytes/s each way


def roofline_terms(flops: float, bytes_accessed: float,
                   coll_bytes: float, chips: int) -> dict[str, float]:
    return {
        "compute_s": flops / (chips * PEAK_FLOPS),
        "memory_s": bytes_accessed / (chips * HBM_BW),
        "collective_s": coll_bytes / (chips * NVLINK_BW),
    }


def dominant(terms: dict[str, float]) -> str:
    return max(("compute_s", "memory_s", "collective_s"),
               key=lambda k: terms[k])


def model_flops(cfg, shape, active: bool = True) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE); decode: D = new
    tokens only."""
    n = param_count_active(cfg) if active else param_count_total(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch            # decode: one token each


def _block_params(cfg, block_type: str) -> float:
    d, ff = cfg.d_model, cfg.d_ff
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn = d * (H + 2 * K) * hd + H * hd * d
    mlp = 3 * d * ff
    if block_type == "dense":
        return attn + mlp
    if block_type == "moe":
        E = cfg.num_experts
        return attn + d * E + 3 * d * ff * E
    if block_type in ("mamba", "hybrid"):
        di = cfg.ssm_expand * d
        Hm = di // 64
        m = d * (2 * di + 2 * cfg.ssm_state + Hm) + di * d + di
        return m + (attn + mlp if block_type == "hybrid" else 0)
    if block_type == "mlstm":
        di = cfg.ssm_expand * d
        return 2 * d * di + 3 * di * di + di * d
    if block_type == "slstm":
        from repro_torch.models.xlstm import slstm_ff_dim
        return 4 * d * d + 4 * d * (d // H) + 3 * d * slstm_ff_dim(cfg)
    if block_type == "enc":
        return attn + 2 * d * ff
    if block_type == "dec":
        return 2 * attn + 2 * d * ff
    raise KeyError(block_type)


def _moe_active_params(cfg) -> float:
    d = cfg.d_model
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn = d * (H + 2 * K) * hd + H * hd * d
    return attn + d * cfg.num_experts + 3 * d * cfg.d_ff * cfg.moe_top_k


def param_count_total(cfg) -> float:
    from repro_torch.models import model as model_lib
    layout = model_lib.global_layout(cfg)
    n = sum(_block_params(cfg, t) for t in layout)
    if cfg.family == "audio":
        n += sum(_block_params(cfg, "dec")
                 for _ in range(cfg.decoder_layers))
    n += 2 * cfg.vocab_size * cfg.d_model
    return n


def param_count_active(cfg) -> float:
    if cfg.family != "moe":
        return param_count_total(cfg)
    from repro_torch.models import model as model_lib
    layout = model_lib.global_layout(cfg)
    n = sum(_moe_active_params(cfg) for _ in layout)
    n += 2 * cfg.vocab_size * cfg.d_model
    return n
