"""Analytic per-device cost model for the roofline (DESIGN.md §8).

The port of ``repro.launch.cost_model``, copied whole with its imports
changed: the same closed-form FLOPs, collective bytes and HBM bytes of
one step of the JAX engine on its production mesh (``Combo``: D =
16 x extra_data x pods data shards; M + S - 1 ticks, pad slots,
capacity-factor MoE dispatch, remat recompute and score materialization
included), so every dict is the JAX package's to the bit. ``roofline``
divides them by the H100 peaks of ``launch/analysis.py``.

Two differences from the program the port runs, which a comparison with
a traced count (``compat.cost_analysis``, ``launch/dryrun.py``) must set
by hand: the port's engine skips the JAX engine's invalid ticks, so it
runs M ticks of work, not M + S - 1 (set ``ticks = M``); and it folds
stage and tensor onto one device, so its count over the whole mesh
divided by S x Tp is the per-device figure.

All numbers are PER DEVICE for one step. Comm byte conventions:
ring all-reduce = 2x payload, all-gather/reduce-scatter = 1x payload,
ppermute = 1x payload.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models.mamba2 import DEFAULT_CHUNK, MAMBA_HEAD_DIM


@dataclasses.dataclass
class Combo:
    cfg: ModelConfig
    shape: InputShape
    multi_pod: bool = False

    # derived
    def __post_init__(self):
        c, s = self.cfg, self.shape
        self.S = c.pipeline_stages
        self.Tp = c.tensor_parallel
        self.D = 16 * c.extra_data * (2 if self.multi_pod else 1)
        self.data_sharded = s.global_batch % self.D == 0 and \
            s.global_batch >= self.D
        self.B_loc = s.global_batch // self.D if self.data_sharded \
            else s.global_batch
        self.chunked = (s.kind == "prefill" and c.prefill_seq_chunks > 1)
        if s.kind == "decode":
            self.M = max(1, min(self.B_loc, self.S))
            while self.B_loc % self.M:
                self.M -= 1
            self.mb = self.B_loc // self.M
        elif self.chunked:
            self.M = c.prefill_seq_chunks
            self.mb = self.B_loc          # every seq, a chunk of it
        else:
            self.M = self.B_loc
            self.mb = self.B_loc // self.M
        self.ticks = self.M + self.S - 1
        self.seq = s.seq_len
        self.chunk_len = s.seq_len // self.M if self.chunked else s.seq_len
        if c.num_prefix_tokens and s.kind != "decode":
            pass                                          # seq already total
        self.W = self._cache_len()

    def _cache_len(self):
        c, s = self.cfg, self.shape
        if c.family == "audio":
            return min(s.seq_len, c.max_target_positions)
        if c.sliding_window:
            return min(s.seq_len, c.sliding_window)
        return s.seq_len


BYTES_BF16 = 2
BYTES_F32 = 4


# ------------------------- per-block forward flops -----------------------

def _attn_flops(c: ModelConfig, tokens, seq_q, seq_k, causal=True,
                window=0, per_shard=True):
    H, K, hd, d = c.num_heads, c.num_kv_heads, c.head_dim, c.d_model
    proj = 2 * tokens * d * (H + 2 * K) * hd + 2 * tokens * H * hd * d
    eff_k = min(seq_k, window) if window else seq_k
    frac = 0.5 if (causal and not window) else 1.0
    scores = 2 * 2 * tokens * eff_k * frac * H * hd
    f = proj + scores
    return f / (c.tensor_parallel if per_shard else 1)


def _mlp_flops(c, tokens, gated=True):
    n = 3 if gated else 2
    return 2 * n * tokens * c.d_model * c.d_ff / c.tensor_parallel


def _moe_flops(c, tokens):
    router = 2 * tokens * c.d_model * c.num_experts
    cap_tokens = tokens * c.moe_top_k * c.capacity_factor
    experts = 2 * 3 * cap_tokens * c.d_model * c.d_ff
    return (router + experts) / c.tensor_parallel


def _mamba_flops(c, tokens, chunk=DEFAULT_CHUNK):
    d = c.d_model
    di = c.ssm_expand * d
    N = c.ssm_state
    Hm = di // MAMBA_HEAD_DIM
    P = MAMBA_HEAD_DIM
    in_dim = 2 * di + 2 * N + Hm
    proj = 2 * tokens * d * in_dim + 2 * tokens * di * d
    conv = 2 * tokens * (di + 2 * N) * c.ssm_conv_width
    Q = min(chunk, tokens)
    # chunked SSD (jnp path): cb shared over heads; intra/inter per head
    ssd = tokens * (2 * Q * N                      # cb
                    + Hm * (2 * Q * P              # M @ x
                            + 4 * N * P))          # inter y + state inj
    return proj + conv + ssd                        # tp=1 for mamba archs


def _mlstm_flops(c, tokens, seq):
    d = c.d_model
    di = c.ssm_expand * d
    H, dh = c.num_heads, di // c.num_heads
    proj = 2 * 2 * tokens * d * di / c.tensor_parallel
    qkvg = (3 * 2 * tokens * di * di + 2 * tokens * di * 2 * H) \
        / c.tensor_parallel
    mat = 2 * 2 * tokens * seq * 0.5 * di / c.tensor_parallel
    down = 2 * tokens * di * d / c.tensor_parallel
    return proj + qkvg + mat + down


def _slstm_flops(c, tokens):
    from repro_torch.models.xlstm import slstm_ff_dim
    d = c.d_model
    dh = d // c.num_heads
    wx = 2 * tokens * d * 4 * d / c.tensor_parallel
    rec = 2 * tokens * d * 4 * dh / c.tensor_parallel
    ffn = 2 * 3 * tokens * d * slstm_ff_dim(c) / c.tensor_parallel
    return wx + rec + ffn


def block_forward_flops(c: ModelConfig, t: str, tokens, seq_q, seq_k, *,
                        causal=True, window=0):
    if t == "dense":
        return _attn_flops(c, tokens, seq_q, seq_k, causal, window) \
            + _mlp_flops(c, tokens)
    if t == "moe":
        return _attn_flops(c, tokens, seq_q, seq_k, causal, window) \
            + _moe_flops(c, tokens)
    if t == "mamba":
        return _mamba_flops(c, tokens)
    if t == "hybrid":
        return (_mamba_flops(c, tokens)
                + _attn_flops(c, tokens, seq_q, seq_k, causal, window)
                + _mlp_flops(c, tokens))
    if t == "mlstm":
        return _mlstm_flops(c, tokens, seq_q)
    if t == "slstm":
        return _slstm_flops(c, tokens)
    if t == "enc":
        return _attn_flops(c, tokens, seq_q, seq_k, causal=False) \
            + _mlp_flops(c, tokens, gated=False)
    if t == "dec":
        return (_attn_flops(c, tokens, seq_q, seq_k, True, window)
                + _attn_flops(c, tokens, seq_q, c.num_audio_frames,
                              causal=False)
                + _mlp_flops(c, tokens, gated=False))
    raise KeyError(t)


def block_decode_flops(c: ModelConfig, t: str, tokens, W):
    """One new token per sequence, cache length W."""
    return block_forward_flops(c, t, tokens, 1, W, causal=False, window=0)


# --------------------------- per-combo totals ----------------------------

def _layouts(c: ModelConfig):
    outs = [tuple(c.slot_layout)]
    if c.family == "audio":
        outs.append(tuple(c.decoder_slot_layout))
    return outs


def flops_per_device(co: Combo) -> dict:
    c, s = co.cfg, co.shape
    out = {}
    win = c.sliding_window
    if s.kind in ("train", "prefill"):
        mult = 4.0 if s.kind == "train" else 1.0   # fwd+bwd(2x)+remat(1x)
        tokens = co.mb * (co.chunk_len if co.chunked else co.seq)
        if c.family == "audio":
            tok_e = co.mb * c.num_audio_frames
            enc = sum(block_forward_flops(c, t, tok_e, c.num_audio_frames,
                                          c.num_audio_frames, causal=False)
                      for t in c.slot_layout)
            dec = sum(block_forward_flops(c, t, tokens, co.seq, co.seq,
                                          window=win)
                      for t in c.decoder_slot_layout)
            blocks = co.ticks * (enc + dec)
        else:
            blocks = co.ticks * sum(
                block_forward_flops(c, t, tokens, co.seq, co.seq, window=win)
                for t in c.slot_layout)
        out["blocks"] = blocks * mult
        # head: vocab sharded over S*Tp model devices, full (data-local) batch
        head_tokens = co.B_loc * co.seq if s.kind == "train" else co.B_loc
        head = 2 * head_tokens * c.d_model * c.vocab_size / (co.S * co.Tp)
        out["head"] = head * (3.0 if s.kind == "train" else 1.0)
    else:
        tokens = co.mb                               # one token per seq
        layout = c.decoder_slot_layout if c.family == "audio" \
            else c.slot_layout
        blocks = co.ticks * sum(block_decode_flops(c, t, tokens, co.W)
                                for t in layout)
        out["blocks"] = blocks
        out["head"] = 2 * co.B_loc * c.d_model * c.vocab_size / (co.S * co.Tp)
    out["total"] = out["blocks"] + out["head"]
    return out


def _n_tp_psums(t: str) -> int:
    return {"dense": 2, "moe": 2, "hybrid": 2, "mlstm": 1, "slstm": 1,
            "enc": 2, "dec": 3, "mamba": 0}[t]


def _n_tp_gathers(t: str) -> int:
    return {"mlstm": 2, "slstm": 1}.get(t, 0)


def collective_bytes_per_device(co: Combo) -> dict:
    c, s = co.cfg, co.shape
    d = c.d_model
    seq = 1 if s.kind == "decode" else \
        (co.chunk_len if co.chunked else co.seq)
    act = co.mb * seq * d * BYTES_BF16
    layouts = _layouts(c)
    out = {}

    # pipeline ppermute: one activation per tick (x2 in backward)
    bwd = 2.0 if s.kind == "train" else 1.0
    out["ppermute"] = co.ticks * act * bwd * len(layouts)

    # tensor-parallel psums/gathers inside blocks
    tp_b = 0.0
    if co.Tp > 1:
        fr = (co.Tp - 1) / co.Tp
        for layout in layouts:
            for t in layout:
                tp_b += _n_tp_psums(t) * 2 * act * fr
                gsz = co.mb * seq * c.ssm_expand * d * BYTES_BF16
                tp_b += _n_tp_gathers(t) * gsz * fr
        tp_b *= co.ticks * bwd
    out["tp"] = tp_b

    # MoE: none beyond the block psum (masked-local dispatch, psum combine)

    # vocab-parallel embed psum (f32) + loss psums (small)
    n_model = co.S * co.Tp
    fr_m = (n_model - 1) / n_model
    toks_total = co.B_loc * (co.seq if s.kind != "decode" else 1)
    out["embed_psum"] = 2 * toks_total * d * BYTES_F32 * fr_m * bwd

    # data-parallel gradient all-reduce (params are model-sharded 16-way)
    if s.kind == "train":
        n_params_dev = _params_per_device(c)
        out["grad_allreduce"] = 2 * n_params_dev * BYTES_F32 \
            * (co.D - 1) / co.D
    else:
        out["grad_allreduce"] = 0.0
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


def _params_per_device(c: ModelConfig) -> float:
    from repro_torch.launch.analysis import param_count_total
    return param_count_total(c) / (c.pipeline_stages * c.tensor_parallel)


def hbm_bytes_per_device(co: Combo) -> dict:
    """Approximate HBM traffic: weight passes + activation traffic +
    attention-score materialization (the plain path materializes
    [mb, H, seq, seq_k] scores; the flash kernel K4 keeps them on chip —
    both reported)."""
    c, s = co.cfg, co.shape
    pdev = _params_per_device(c)
    out = {}
    if s.kind == "train":
        # fwd read + remat read + bwd read + grads w/r + opt p r/w + m r/w
        out["weights"] = pdev * BYTES_F32 * 9
    else:
        out["weights"] = pdev * BYTES_F32 * 1
    seq = 1 if s.kind == "decode" else \
        (co.chunk_len if co.chunked else co.seq)
    act = co.mb * seq * c.d_model * BYTES_BF16
    n_slots = sum(len(l) for l in _layouts(c))
    alpha = 12                                   # sub-op reads+writes / slot
    mult = 3.0 if s.kind == "train" else 1.0
    out["activations"] = co.ticks * n_slots * alpha * act * mult

    # attention score materialization (plain path; the flash kernel keeps
    # score tiles on chip -> zero HBM score traffic)
    score = 0.0
    win = c.sliding_window
    for layout in _layouts(c):
        for t in layout:
            if c.use_flash_attention:
                continue
            if t in ("dense", "moe", "hybrid", "enc", "dec"):
                kl = co.W if s.kind == "decode" else \
                    (min(co.seq, win) if win else co.seq)
                frac = 0.5 if s.kind != "decode" and not win else 1.0
                score += (co.mb * c.num_heads / co.Tp * seq * kl * frac
                          * BYTES_F32 * 2)
    out["scores"] = co.ticks * score * mult

    # decode: KV/state cache read+write
    if s.kind == "decode":
        cache = 0.0
        for layout in _layouts(c):
            for t in layout:
                if t in ("dense", "moe", "hybrid", "dec"):
                    kv_sh = max(1, c.num_kv_heads // co.Tp) \
                        if c.num_kv_heads >= co.Tp else c.num_kv_heads
                    cache += 2 * co.B_loc * co.W * kv_sh * c.head_dim \
                        * BYTES_BF16
                if t in ("mamba", "hybrid"):
                    di = c.ssm_expand * c.d_model
                    cache += co.B_loc * (di // MAMBA_HEAD_DIM) \
                        * MAMBA_HEAD_DIM * c.ssm_state * BYTES_F32
                if t == "mlstm":
                    di = c.ssm_expand * c.d_model
                    dh = di // c.num_heads
                    cache += co.B_loc * (c.num_heads / co.Tp) * dh * dh \
                        * BYTES_F32
        out["cache"] = cache * 2                  # read + write
    else:
        out["cache"] = 0.0
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


def roofline(co: Combo) -> dict:
    from repro_torch.launch.analysis import HBM_BW, NVLINK_BW, PEAK_FLOPS
    f = flops_per_device(co)
    cb = collective_bytes_per_device(co)
    hb = hbm_bytes_per_device(co)
    terms = {
        "compute_s": f["total"] / PEAK_FLOPS,
        "memory_s": hb["total"] / HBM_BW,
        "collective_s": cb["total"] / NVLINK_BW,
    }
    dom = max(terms, key=terms.get)
    return {"flops": f, "collective_bytes": cb, "hbm_bytes": hb,
            "terms": terms, "dominant": dom}
