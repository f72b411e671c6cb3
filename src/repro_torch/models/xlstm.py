"""xLSTM layers: mLSTM (matrix memory, parallel form) and sLSTM (scalar
memory, sequential scan), per arXiv:2405.04517.

The port of ``repro.models.xlstm``, with its parameter layout (every
weight that touches heads carries an explicit head axis) and its
numerics: the recurrences and stabilisers in f32, the projections in the
call's dtype. The stabiliser ``m`` starts at -1e30 and stays f32. The
mixers take a ``TP`` as the JAX package's do; the port has ``TP.none()``
only, so its gathers are identities.

The sLSTM scan (``lax.scan`` in the JAX package) is a Python loop over
time here, one cell step after the other in the same order of
operations (on the meta device, all steps at once: ``_slstm_scan_meta``).
No Pallas kernel exists for either layer in the JAX package.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import modules
from repro_torch.models.tp import TP

f32 = torch.float32
M_INIT = -1e30


# ================================ mLSTM =================================

def mlstm_dims(cfg: ModelConfig):
    di = cfg.ssm_expand * cfg.d_model
    H = cfg.num_heads
    return di, H, di // H


def init_mlstm(gen: torch.Generator, cfg: ModelConfig, dtype=f32):
    d = cfg.d_model
    di, H, dh = mlstm_dims(cfg)
    dev = gen.device
    si = 1.0 / math.sqrt(di)

    def randn(*shape):
        return modules.randn(gen, shape, dtype)

    return {
        "up_x": modules.dense_init(gen, d, di, dtype=dtype),
        "up_z": modules.dense_init(gen, d, di, dtype=dtype),
        "conv_w": randn(cfg.ssm_conv_width, di) * 0.25,
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "wq": randn(di, H, dh) * si,
        "wk": randn(di, H, dh) * si,
        "wv": randn(di, H, dh) * si,
        "wgate": randn(di, H, 2) * si,
        "f_bias": torch.full((H,), 3.0, dtype=dtype, device=dev),
        "gn": {"scale": torch.ones((H, dh), dtype=dtype, device=dev)},
        "down": randn(H, dh, d) * si,
    }


def _causal_conv(x, w, b):
    K = w.shape[0]
    pad = F.pad(x, (0, 0, K - 1, 0))
    return sum(pad[:, i:i + x.shape[1], :] * w[i] for i in range(K)) + b


def _group_norm(scale, xh, eps=1e-5):
    """xh: [B, S, H, dh]; scale: [H, dh]. Per-head LayerNorm without bias
    (the population variance, as ``jnp.var``)."""
    xf = xh.to(f32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps) * scale.to(f32)
    return y.to(xh.dtype)


def _sqrt(n: int):
    """sqrt(n) in f32, as ``jnp.sqrt(float(n))`` (a 0-d CPU tensor, which
    a CUDA op takes as a scalar, with no copy to the card)."""
    return torch.sqrt(torch.tensor(float(n), dtype=f32))


def _heads(x, w):
    """einsum ``bsd,dhk->bshk``."""
    return torch.einsum("bsd,dhk->bshk", x, w)


def _gates(p, xm):
    """Input and log-forget gates in f32 from the full-width ``xm``."""
    g = _heads(xm.to(f32), p["wgate"].to(f32))
    ig, fg = g[..., 0], g[..., 1]                    # [B,S,Hl]
    return ig, F.logsigmoid(fg + p["f_bias"].to(f32))


def _mlstm_out(p, h, z_l, dtype):
    """Group norm, the ``silu(z)`` gate and the down projection."""
    B, S, Hl, dh = h.shape
    h = _group_norm(p["gn"]["scale"], h)
    zh = z_l.reshape(B, S, Hl, dh)
    return torch.einsum("bshk,hkd->bsd", (h * F.silu(zh)).to(dtype),
                        p["down"].to(dtype))


def _mlstm_qkvg(p, x, dtype, tp: TP):
    """Shared preamble: up-proj, conv, gathered activations, local
    q/k/v/gates."""
    xm_l = modules.dense(p["up_x"], x, dtype)        # [B,S,di_local]
    z_l = modules.dense(p["up_z"], x, dtype)
    xc_l = F.silu(_causal_conv(xm_l, p["conv_w"].to(dtype),
                               p["conv_b"].to(dtype)))
    xm = tp.all_gather(xm_l, axis=-1)                # full di
    xc = tp.all_gather(xc_l, axis=-1)
    q = _heads(xc, p["wq"].to(dtype))
    k = _heads(xc, p["wk"].to(dtype))
    v = _heads(xm, p["wv"].to(dtype))
    ig, logf = _gates(p, xm)
    return xm_l, z_l, q, k, v, ig, logf


def _causal_seg(cumf, ig):
    """In-sequence pair log-weights ``cumf_t - cumf_s + ig_s`` for s <= t,
    -inf above the diagonal (set before any ``exp``). [B, T, S, H]."""
    S = cumf.shape[1]
    seg = cumf[:, :, None, :] - cumf[:, None, :, :] + ig[:, None, :, :]
    tri = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                device=cumf.device))[None, :, :, None]
    return torch.where(tri, seg, -math.inf)


def mlstm_mixer(p, x, *, cfg: ModelConfig, dtype=torch.bfloat16,
                tp: TP = TP.none()):
    """Parallel (training) form. x: [B,S,d] -> partial [B,S,d]."""
    di, H, dh = mlstm_dims(cfg)
    _, z_l, q, k, v, ig, logf = _mlstm_qkvg(p, x, dtype, tp)
    q, k, v = q.to(f32), k.to(f32), v.to(f32)

    cumf = torch.cumsum(logf, dim=1)                 # [B,S,Hl]
    seg = _causal_seg(cumf, ig)
    m = torch.amax(seg, dim=2, keepdim=True)         # [B,S,1,Hl]
    D = torch.exp(seg - m)

    scores = torch.einsum("bthk,bshk->btsh", q, k) / _sqrt(dh)
    W = scores * D
    norm = torch.maximum(torch.abs(torch.sum(W, dim=2)),
                         torch.exp(-m[:, :, 0, :]))
    h = torch.einsum("btsh,bshk->bthk", W, v) / norm[..., None]
    return _mlstm_out(p, h.to(dtype), z_l, dtype)    # partial over heads


def mlstm_mixer_chunk(p, x, cache, *, cfg: ModelConfig, dtype=torch.bfloat16,
                      tp: TP = TP.none()):
    """Chunked-prefill mLSTM: parallel form within the chunk + carried
    stabilized matrix state (C, n, m) across chunks, the chunk analogue of
    ``mlstm_step``. Returns (partial_out [B,L,d], new_cache)."""
    di, H, dh = mlstm_dims(cfg)
    L = x.shape[1]
    xm_l = modules.dense(p["up_x"], x, dtype)
    z_l = modules.dense(p["up_z"], x, dtype)
    hist = torch.cat([cache["conv"].to(dtype), xm_l], dim=1)
    K = p["conv_w"].shape[0]
    w = p["conv_w"].to(dtype)
    xc_l = F.silu(sum(hist[:, i:i + L, :] * w[i] for i in range(K))
                  + p["conv_b"].to(dtype))
    xm = tp.all_gather(xm_l, axis=-1)
    xc = tp.all_gather(xc_l, axis=-1)
    q = _heads(xc, p["wq"].to(dtype)).to(f32)
    k = _heads(xc, p["wk"].to(dtype)).to(f32)
    v = _heads(xm, p["wv"].to(dtype)).to(f32)
    ig, logf = _gates(p, xm)

    C0, n0, m0 = cache["C"], cache["n"], cache["m"]      # [B,Hl,...]
    cumf = torch.cumsum(logf, dim=1)                     # [B,L,Hl]
    seg = _causal_seg(cumf, ig)
    # the stabilizer covers both in-chunk pairs and the carried state term
    carry_log = cumf + m0[:, None, :]                    # [B,L,Hl]
    m_t = torch.maximum(torch.amax(seg, dim=2), carry_log)
    D = torch.exp(seg - m_t[:, :, None, :])
    carry_w = torch.exp(carry_log - m_t)                 # [B,L,Hl]

    k_sc = k / _sqrt(dh)
    scores = torch.einsum("bthk,bshk->btsh", q, k_sc)
    Wm = scores * D
    num = (torch.einsum("btsh,bshk->bthk", Wm, v)
           + carry_w[..., None] * torch.einsum("bhvk,bthk->bthv", C0, q))
    den_in = (torch.sum(Wm, dim=2)
              + carry_w * torch.einsum("bhk,bthk->bth", n0, q))
    den = torch.maximum(torch.abs(den_in), torch.exp(-m_t))
    out = _mlstm_out(p, (num / den[..., None]).to(dtype), z_l, dtype)

    # state update at the chunk's end
    tot = cumf[:, -1, :]                                 # [B,Hl]
    m_new = torch.maximum(tot + m0, torch.amax(tot[:, None, :] - cumf + ig,
                                               dim=1))
    w_s = torch.exp(tot[:, None, :] - cumf + ig - m_new[:, None, :])
    decay = torch.exp(tot + m0 - m_new)
    C_new = (decay[..., None, None] * C0
             + torch.einsum("bsh,bshv,bshk->bhvk", w_s, v, k_sc))
    n_new = decay[..., None] * n0 + torch.einsum("bsh,bshk->bhk", w_s, k_sc)
    new_cache = {"C": C_new, "n": n_new, "m": m_new,
                 "conv": hist[:, -(K - 1):, :].to(cache["conv"].dtype)}
    return out, new_cache


def init_mlstm_cache(cfg: ModelConfig, batch: int,
                     heads_local: int | None = None, device="cpu"):
    di, H, dh = mlstm_dims(cfg)
    Hl = heads_local or H
    return {
        "C": torch.zeros((batch, Hl, dh, dh), dtype=f32, device=device),
        "n": torch.zeros((batch, Hl, dh), dtype=f32, device=device),
        "m": torch.full((batch, Hl), M_INIT, dtype=f32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, di // H * Hl),
                            dtype=f32, device=device),
    }


def mlstm_step(p, x, cache, *, cfg: ModelConfig, dtype=torch.bfloat16,
               tp: TP = TP.none()):
    """Recurrent decode step. x: [B,1,d] -> (partial [B,1,d], cache)."""
    di, H, dh = mlstm_dims(cfg)
    xm_l = modules.dense(p["up_x"], x, dtype)
    z_l = modules.dense(p["up_z"], x, dtype)
    hist = torch.cat([cache["conv"].to(dtype), xm_l], dim=1)
    K = p["conv_w"].shape[0]
    xc_l = F.silu(torch.sum(hist[:, -K:, :] * p["conv_w"].to(dtype), dim=1,
                            keepdim=True) + p["conv_b"].to(dtype))
    xm = tp.all_gather(xm_l, axis=-1)
    xc = tp.all_gather(xc_l, axis=-1)
    q = _heads(xc, p["wq"].to(dtype))[:, 0].to(f32)
    k = _heads(xc, p["wk"].to(dtype))[:, 0].to(f32)
    v = _heads(xm, p["wv"].to(dtype))[:, 0].to(f32)
    ig, logf = (g[:, 0] for g in _gates(p, xm))

    m_new = torch.maximum(logf + cache["m"], ig)
    f_s = torch.exp(logf + cache["m"] - m_new)
    i_s = torch.exp(ig - m_new)
    k_sc = k / _sqrt(dh)
    C = (f_s[..., None, None] * cache["C"]
         + i_s[..., None, None] * (v[..., :, None] * k_sc[..., None, :]))
    n = f_s[..., None] * cache["n"] + i_s[..., None] * k_sc
    num = torch.einsum("bhvk,bhk->bhv", C, q)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n, q)),
                        torch.exp(-m_new))
    h = (num / den[..., None])[:, None].to(dtype)        # [B,1,Hl,dh]
    out = _mlstm_out(p, h, z_l, dtype)
    return out, {"C": C, "n": n, "m": m_new,
                 "conv": hist[:, 1:, :].to(cache["conv"].dtype)}


# ================================ sLSTM =================================

def slstm_dims(cfg: ModelConfig):
    H = cfg.num_heads
    return H, cfg.d_model // H


def slstm_ff_dim(cfg: ModelConfig) -> int:
    return int(cfg.d_model * 4 / 3 / 8) * 8


def init_slstm(gen: torch.Generator, cfg: ModelConfig, dtype=f32):
    d = cfg.d_model
    H, dh = slstm_dims(cfg)
    ffd = slstm_ff_dim(cfg)
    dev = gen.device

    def randn(*shape):
        return modules.randn(gen, shape, dtype)

    return {
        "w": randn(d, H, 4 * dh) * (1.0 / math.sqrt(d)),
        "b": torch.zeros((H, 4 * dh), dtype=dtype, device=dev),
        "r": randn(H, dh, 4 * dh) / math.sqrt(dh),
        "f_bias": torch.full((H, dh), 3.0, dtype=dtype, device=dev),
        "gn": {"scale": torch.ones((H, dh), dtype=dtype, device=dev)},
        "up_u": modules.dense_init(gen, d, ffd, dtype=dtype),
        "up_g": modules.dense_init(gen, d, ffd, dtype=dtype),
        "down": modules.dense_init(gen, ffd, d, dtype=dtype),
    }


def _slstm_cell(p, wx_t, state):
    """wx_t: [B,Hl,4dh] = W x_t + b (the recurrent term is added here)."""
    c, n, h, m = state
    rec = torch.einsum("bhd,hdk->bhk", h, p["r"].to(f32))
    z, i, f, o = torch.chunk(wx_t + rec, 4, dim=-1)
    f = f + p["f_bias"].to(f32)
    logf = F.logsigmoid(f)
    m_new = torch.maximum(logf + m, i)
    i_s = torch.exp(i - m_new)
    f_s = torch.exp(logf + m - m_new)
    c_new = f_s * c + i_s * torch.tanh(z)
    n_new = f_s * n + i_s
    h_new = torch.sigmoid(o) * c_new / torch.clamp(n_new, min=1.0)
    return (c_new, n_new, h_new, m_new)


def init_slstm_state(cfg: ModelConfig, batch: int,
                     heads_local: int | None = None, device="cpu"):
    H, dh = slstm_dims(cfg)
    shape = (batch, heads_local or H, dh)

    def z():
        return torch.zeros(shape, dtype=f32, device=device)

    return (z(), z(), z(), torch.full(shape, M_INIT, dtype=f32,
                                      device=device))


def _slstm_wx(p, x):
    """``W x + b`` in f32 for every step: [B, S, Hl, 4dh]."""
    return _heads(x.to(f32), p["w"].to(f32)) + p["b"].to(f32)


def _slstm_scan(p, wx, state):
    """The cell over time, one step after the other. Returns (final
    state, hs [B, S, Hl, dh])."""
    if wx.is_meta:
        return _slstm_scan_meta(p, wx, state)
    hs = []
    for t in range(wx.shape[1]):
        state = _slstm_cell(p, wx[:, t], state)
        hs.append(state[2])
    return state, torch.stack(hs, dim=1)


def _slstm_scan_meta(p, wx, state):
    """``_slstm_scan``'s shapes, and the products a FLOP count sees, on
    the meta device, which computes nothing (``launch/dryrun.py``): all
    steps at once, where the loop would spend ~15 meta operations of host
    time a step (hours for a 32k prefill). Step 0's recurrent product
    reads the state's h; the later steps' read a stand-in h that depends
    on wx, the state and r as the loop's does, so ``FlopCounterMode``
    counts the loop's products, forward and backward, exactly."""
    c, n, h, m = state
    r = p["r"].to(f32)
    rec0 = torch.einsum("bhd,hdk->bhk", h, r)[:, None]
    z, _, _, o = torch.chunk(wx[:, :-1] + rec0, 4, dim=-1)
    h_prev = torch.sigmoid(o) * torch.tanh(z)
    rec = torch.cat([rec0, torch.einsum("bshd,hdk->bshk", h_prev, r)],
                    dim=1)
    z, i, f, o = torch.chunk(wx + rec, 4, dim=-1)
    logf = F.logsigmoid(f + p["f_bias"].to(f32))
    m_all = torch.maximum(logf + m[:, None], i)
    c_all = torch.exp(logf - m_all) * c[:, None] + torch.tanh(z)
    n_all = torch.exp(i - m_all) + n[:, None]
    hs = torch.sigmoid(o) * c_all / n_all
    return (c_all[:, -1], n_all[:, -1], hs[:, -1], m_all[:, -1]), hs


def _slstm_out(p, hs, dtype, tp: TP):
    """Group norm of the hidden states, then the gated GELU FFN."""
    B, S = hs.shape[:2]
    y_l = _group_norm(p["gn"]["scale"], hs.to(dtype)).reshape(B, S, -1)
    y = tp.all_gather(y_l, axis=-1)                  # full d
    u = modules.dense(p["up_u"], y, dtype)
    g = modules.dense(p["up_g"], y, dtype)
    gelu = modules.activation("gelu")                # tanh form, as jax's
    return modules.dense(p["down"], gelu(u) * torch.sigmoid(g), dtype)


def slstm_mixer(p, x, *, cfg: ModelConfig, dtype=torch.bfloat16,
                tp: TP = TP.none(), h0=None):
    """x: [B,S,d] -> partial [B,S,d]."""
    wx = _slstm_wx(p, x)
    state = h0 if h0 is not None else init_slstm_state(
        cfg, x.shape[0], wx.shape[2], device=x.device)
    _, hs = _slstm_scan(p, wx, state)
    return _slstm_out(p, hs, dtype, tp)


def slstm_mixer_chunk(p, x, cache, *, cfg: ModelConfig, dtype=torch.bfloat16,
                      tp: TP = TP.none()):
    """Chunked-prefill sLSTM: the scan continues from the carried state.
    cache: {c, n, h, m}. Returns (partial_out, new_cache)."""
    st = (cache["c"], cache["n"], cache["h"], cache["m"])
    st2, hs = _slstm_scan(p, _slstm_wx(p, x), st)
    out = _slstm_out(p, hs, dtype, tp)
    return out, {"c": st2[0], "n": st2[1], "h": st2[2], "m": st2[3]}


def slstm_step(p, x, state, *, cfg: ModelConfig, dtype=torch.bfloat16,
               tp: TP = TP.none()):
    """Decode step. x: [B,1,d] -> (partial [B,1,d], state)."""
    wx = torch.einsum("bsd,dhk->bhk", x.to(f32), p["w"].to(f32)) \
        + p["b"].to(f32)
    state = _slstm_cell(p, wx, state)
    return _slstm_out(p, state[2][:, None], dtype, tp), state
