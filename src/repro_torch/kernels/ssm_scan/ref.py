"""Plain PyTorch versions of the SSD scan kernel (K5).

The counterpart of ``repro.kernels.ssm_scan.ref`` and of the JAX
package's jnp ``repro.models.mamba2.ssd_chunked`` (K5's own oracle): the
chunked scan, its padded entry point and the literal recurrence. They
take an initial state ``h0`` and return the final state ``h_final`` as
``ssd_chunked`` does, which chunked prefill needs. The model reaches them
on the CPU only, through ``ops.ssd_scan``; on the card ``chip_smoke.py``
holds the kernel against them.

One change from ``ssd_chunked``: above the diagonal of a chunk, ``seg``
is positive and ``exp(seg)`` can overflow. JAX's ``where`` selects it
away in the forward, but its gradient there is ``0 * inf = NaN``. Here
``seg`` is set to ``-inf`` first, so ``exp`` gives the same 0 and a 0
gradient. Every value the forward returns is the JAX package's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

f32 = torch.float32


def ssd_chunked(xh, dt, A, Bm, Cm, D, chunk: int = 128, h0=None):
    """Chunked SSD scan.

    xh: [B, S, H, P]; dt: [B, S, H] (post-softplus); A: [H] (negative);
    Bm, Cm: [B, S, N]; D: [H]; h0: [B, H, P, N] or None (zeros). S must
    be a multiple of ``chunk``. Returns (y [B, S, H, P], h_final
    [B, H, P, N]).
    """
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"ssd_chunked: S={S} is not a multiple of the "
                         f"chunk {chunk}")
    nc = S // chunk
    xc = xh.reshape(Bsz, nc, chunk, H, P)
    dtc = dt.reshape(Bsz, nc, chunk, H)
    Bc = Bm.reshape(Bsz, nc, chunk, N)
    Cc = Cm.reshape(Bsz, nc, chunk, N)

    # log decay per step: la[t] = dt[t] * A  (A<0)
    cum = torch.cumsum(dtc * A, dim=2)                     # L_t inclusive

    # intra-chunk: M[t,s] = (C_t.B_s) * exp(L_t - L_s) * dt_s   (s<=t)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # [B,nc,Q,Q,H]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=xh.device))
    decay = torch.exp(seg.masked_fill(~tri[None, None, :, :, None],
                                      float("-inf")))
    cb = torch.einsum("bctn,bcsn->bcts", Cc, Bc)           # [B,nc,Q,Q]
    M = cb[..., None] * decay * dtc[:, :, None, :, :]      # [B,nc,Q,Q,H]
    y_intra = torch.einsum("bctsh,bcshp->bcthp", M, xc)

    # chunk summaries: state injected by this chunk (at chunk end)
    dec_to_end = torch.exp(cum[:, :, -1:, :] - cum)        # exp(L_Q - L_t)
    inj = torch.einsum("bcth,bctn,bcthp->bchpn", dec_to_end * dtc, Bc, xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])              # [B,nc,H]

    # inter-chunk: the state carried across chunks
    h = (torch.zeros((Bsz, H, P, N), dtype=xh.dtype, device=xh.device)
         if h0 is None else h0)
    starts = []
    for c in range(nc):
        starts.append(h)                                   # state BEFORE c
        h = chunk_decay[:, c, :, None, None] * h + inj[:, c]
    h_starts = torch.stack(starts, dim=1)                  # [B,nc,H,P,N]

    # contribution of the carried state: y_t += C_t . (exp(L_t) * h_start)
    y_inter = torch.einsum("bctn,bchpn,bcth->bcthp", Cc, h_starts,
                           torch.exp(cum))
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y + xh * D[None, None, :, None], h


def _pad_to(a, S_pad):
    """Zeros appended on axis 1 up to ``S_pad``."""
    pad = S_pad - a.shape[1]
    if not pad:
        return a
    return F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))


def ssd_scan_reference(xh, dt, A, Bm, Cm, D, chunk: int = 128, h0=None,
                       return_state: bool = False):
    """The wrapper's function in plain PyTorch: pad to a chunk multiple
    (zero dt: a decay of 1 and nothing injected, so exact), run
    ``ssd_chunked`` in f32, return y in xh's dtype. With ``h0``, or
    ``return_state``, returns (y, h_final [B, H, P, N] f32)."""
    S = xh.shape[1]
    S_pad = -(-S // chunk) * chunk
    y, h = ssd_chunked(*(_pad_to(a.to(f32), S_pad) for a in (xh, dt)),
                       A.to(f32),
                       *(_pad_to(a.to(f32), S_pad) for a in (Bm, Cm)),
                       D.to(f32), chunk=chunk,
                       h0=None if h0 is None else h0.to(f32))
    y = y[:, :S].to(xh.dtype)
    return (y, h) if h0 is not None or return_state else y


def ssd_scan_stepwise(xh, dt, A, Bm, Cm, D, h0=None,
                      return_state: bool = False):
    """The literal per-timestep recurrence (slow, exact):
    ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T``,
    ``y_t = h_t C_t + D x_t``."""
    B, S, H, P = xh.shape
    A, D = A.to(f32), D.to(f32)
    h = (torch.zeros((B, H, P, Bm.shape[-1]), dtype=f32, device=xh.device)
         if h0 is None else h0.to(f32))
    ys = []
    for t in range(S):
        x_t, dt_t = xh[:, t].to(f32), dt[:, t].to(f32)    # [B,H,P], [B,H]
        B_t, C_t = Bm[:, t].to(f32), Cm[:, t].to(f32)      # [B,N]
        a = torch.exp(dt_t * A)
        h = (a[..., None, None] * h
             + dt_t[..., None, None] * x_t[..., None] * B_t[:, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", h, C_t)
                  + x_t * D[None, :, None])
    y = torch.stack(ys, dim=1).to(xh.dtype)
    return (y, h) if h0 is not None or return_state else y
