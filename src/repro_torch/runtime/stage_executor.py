"""Per-stage hot path for the live FTPipeHD runtime, in PyTorch.

The live runtime's unit of work is a contiguous layer slice. This module
gives each slice ONE packed representation and ONE step:

``ChainLayout``
    Per-layer flat-buffer layout for a whole ``runtime/workload.LayerChain``
    (leaf key paths/shapes/dtypes + sizes), built on the flatten helpers of
    ``kernels/fused_sgd/ops.py``. Leaves are ordered as ``jax.tree.flatten``
    orders them (dict keys sorted), so the layer->offset map equals the
    reference's and flat buffers can be swapped between the packages.

``SliceLayout``
    A contiguous [a, e] window of a ``ChainLayout``: the slice's parameters
    (and momentum) live in one flat f32 buffer, and layer ``j``'s weights
    are the view ``buffer[offset(j):offset(j)+size(j)]`` — the currency of
    vertical-sync stash copies, §III-E replication snapshots and §III-F
    redistribution fetches.

``StageExecutor``
    ``forward`` (activation, or loss at the last stage) and a fused
    ``step`` that recomputes the forward under the batch's vertical-sync
    weight version, takes the VJP with ``torch.autograd.grad`` and applies
    the SGD+momentum+weight-decay update through the ``kernels/fused_sgd``
    CUDA kernel. Gradients come out already packed: the forward reads
    weights as views of a detached alias of the flat buffer, so the
    gradient with respect to that alias IS the flat gradient. ``step``
    returns NEW tensors for the parameters and the momentum and writes no
    input: the stash and the replica stores keep references to them.
    ``compiled=False`` keeps the per-layer autograd + ``optim/sgd`` path
    (same packed interface) as a reference.

``forward_q`` / ``step_q`` are the int8-fused wire tier's variants: the
outgoing boundary tensor (activation, or the cotangent ``dx``) leaves
the stage as per-channel u8 codes through the ``kernels/quant`` CUDA
kernel K2, with an error-feedback residual threaded like momentum, and
ships as a ``DeviceQuantized`` (codec tag 13). Every entry point accepts
an inbound ``DeviceQuantized``: it is copied to the device once and
dequantized there by K3 before autograd, so ``dx`` is taken with respect
to the f32 activation the upstream stage's residual accounted for.
"""
from __future__ import annotations

import dataclasses
import math
import threading

import torch

from repro_torch import tree
from repro_torch.kernels import build
from repro_torch.kernels.fused_sgd.ops import (fused_sgd, pack_leaves,
                                               unpack_leaves)
from repro_torch.kernels.quant.ops import dequantize, quantize_ef
from repro_torch.optim.sgd import sgd_update
from repro_torch.runtime.devices import resolve_device
from repro_torch.runtime.qtensor import DeviceQuantized, host_array
from repro_torch.runtime.workload import as_f32, synchronize


def aggregate_packed(bufs) -> torch.Tensor:
    """Mean of same-shape packed flat f32 buffers — THE weight-aggregation
    op of the runtime (§III-C stash averaging in ``runtime/live.Worker``):
    one stacked mean over the flat layout, into a new tensor."""
    return torch.stack(list(bufs)).mean(dim=0)


# ============================ packed layouts =============================

@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Flat-buffer layout of one layer's parameter dict."""
    paths: tuple                 # leaf key paths, sorted-key order
    shapes: tuple
    dtypes: tuple
    size: int                    # total elements across leaves


class ChainLayout:
    """Per-layer packed layout for a whole layer chain."""

    def __init__(self, layers: list[LayerSpec], device=None):
        self.layers = layers
        self.device = torch.device("cpu" if device is None else device)

    @classmethod
    def of_params(cls, params: list) -> "ChainLayout":
        """Derive the layout from a chain's parameter list — a pure
        function of the model definition, so every node computes the
        identical layer->offset map without exchanging metadata."""
        specs, device = [], None
        for p in params:
            leaves, paths = tree.flatten(p)
            shapes = tuple(tuple(l.shape) for l in leaves)
            dtypes = tuple(l.dtype for l in leaves)
            size = int(sum(math.prod(s) for s in shapes))
            specs.append(LayerSpec(tuple(paths), shapes, dtypes, size))
            device = device or (leaves[0].device if leaves else None)
        return cls(specs, device)

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    def layer_size(self, j: int) -> int:
        return self.layers[j].size

    def layer_nbytes(self, j: int) -> int:
        return 4 * self.layers[j].size          # packed f32 on the wire

    def pack_layer(self, j: int, params) -> torch.Tensor:
        """Layer params -> flat f32 [size(j)] (a new tensor)."""
        return pack_leaves(tree.leaves(params))

    def unpack_layer(self, j: int, flat) -> dict:
        """Flat f32 [size(j)] -> layer params (views of ``flat``)."""
        spec = self.layers[j]
        leaves = unpack_leaves(flat, spec.shapes, spec.dtypes)
        return tree.unflatten(list(spec.paths), leaves)

    def slice(self, a: int, e: int) -> "SliceLayout":
        return SliceLayout(self, a, e)


class SliceLayout:
    """Flat-buffer layout of the contiguous layer window [a, e]."""

    def __init__(self, chain_layout: ChainLayout, a: int, e: int):
        self.chain_layout = chain_layout
        self.device = chain_layout.device
        self.a, self.e = a, e
        self.offsets: dict[int, int] = {}
        off = 0
        for j in range(a, e + 1):
            self.offsets[j] = off
            off += chain_layout.layer_size(j)
        self.size = off

    @property
    def layer_ids(self) -> list[int]:
        return list(range(self.a, self.e + 1))

    def view(self, buffer, j: int) -> torch.Tensor:
        """Layer ``j``'s flat weights: a view of the packed buffer."""
        off = self.offsets[j]
        return buffer[off:off + self.chain_layout.layer_size(j)]

    def pack(self, flats: dict) -> torch.Tensor:
        """{layer -> flat f32 (tensor or numpy)} covering [a, e] -> one new
        packed buffer on the layout's device."""
        parts = [as_f32(flats[j], self.device).reshape(-1)
                 for j in self.layer_ids]
        return torch.cat(parts) if parts else self.zeros()

    def unpack_layer(self, buffer, j: int) -> dict:
        return self.chain_layout.unpack_layer(j, self.view(buffer, j))

    def unpack(self, buffer) -> dict[int, dict]:
        return {j: self.unpack_layer(buffer, j) for j in self.layer_ids}

    def zeros(self) -> torch.Tensor:
        return torch.zeros((self.size,), dtype=torch.float32,
                           device=self.device)


# ============================ stage executor =============================

class StageExecutor:
    """Fused fwd/bwd/update for one stage slice on packed flat buffers.

    ``forward(buf, x, batch=None)``
        activation ``y`` (mid stage) or scalar loss (last stage).
    ``step(fwd_buf, new_buf, mom_buf, x, ct=None, batch=None)``
        -> ``(dx, new_buf', mom_buf')``: recompute forward under
        ``fwd_buf`` (the batch's vertical-sync version), backward with
        cotangent ``ct`` (1.0 at the last stage), fused SGD update applied
        to ``new_buf`` (the newest version) — the exact update order of the
        uncompiled path. All three results are new tensors.
    ``forward_q(buf, x, res)`` / ``step_q(..., res=None)``
        the int8-fused variants: the outgoing tensor is quantized on the
        device (K2) with the carried residual ``res``; they return a
        ``DeviceQuantized`` and the new residual — or, where the tensor
        is not finite, the exact f32 values and a zero residual.
    """

    def __init__(self, chain, slice_layout: SliceLayout, *, last: bool,
                 lr: float, momentum: float = 0.9,
                 weight_decay: float = 4e-5, compiled: bool = True,
                 device=None):
        self.device = resolve_device(device)
        self.chain = chain
        self.slice = slice_layout
        self.last = last
        self.compiled = compiled
        self.lr, self.momentum, self.weight_decay = lr, momentum, weight_decay
        # §III-E overlap scheduler: O(1) per-layer change counters, bumped
        # by every step (the whole packed slice is rewritten). The worker
        # snapshots these alongside the weight buffer; a counter equal to
        # the one shadowed at the last ship proves the layer unchanged
        # WITHOUT the byte compare (``Worker._delta_layers`` counters mode).
        self.change_counts: dict[int, int] = {
            j: 0 for j in slice_layout.layer_ids}

    def _run(self, plist, x, batch):
        for j, p in zip(self.slice.layer_ids, plist):
            x = self.chain.apply_layer(j, p, x)
        return self.chain.loss(x, batch) if self.last else x

    def _coerce(self, x):
        """Wire value -> f32 tensor on this executor's device. Decoded
        wire arrays (numpy) move to the device here. A ``DeviceQuantized``
        (tag 13) is the dequantization boundary of the fused tier: its
        codes and params reach the device in one copy and K3 dequantizes
        them there."""
        if isinstance(x, DeviceQuantized):
            return dequantize(*self._device_triple(x))
        return as_f32(x, self.device)

    def _device_triple(self, x: DeviceQuantized):
        """(q u8 [..., C], lo f32 [C], scale f32 [C]) on the device, as
        views of ONE host->device copy of ``lo | scale | codes`` (the f32
        params first, so their views are 4-byte aligned)."""
        C = x.num_channels
        host = torch.frombuffer(bytearray(x.lo + x.scale + x.data),
                                dtype=torch.uint8)
        buf = host.to(self.device)
        params = buf[:8 * C].view(torch.float32)
        return buf[8 * C:].view(x.shape), params[:C], params[C:]

    def _quantize(self, t, res):
        """K2 on an outgoing boundary tensor -> ``(payload, res')``: a
        ``DeviceQuantized`` and the new residual on the device, or — where
        ``t + res`` is not finite — the exact f32 values on the host and a
        zero residual (``bool(ok)`` is the one sync)."""
        t = t.detach().contiguous()
        q, lo, scale, res2, ok, _ = quantize_ef(t, res, with_z=False)
        if bool(ok):
            return DeviceQuantized.from_arrays(q, lo, scale), res2
        z = t if res is None else t + res     # K2's z, formed only here
        return host_array(z), torch.zeros_like(res2)

    def forward(self, buf, x, batch=None):
        """Run the slice forward under packed weights ``buf``: activation
        for a mid stage, scalar loss at the last (``batch`` supplies the
        labels there)."""
        with torch.no_grad():
            return self._run(
                [self.slice.unpack_layer(buf, j) for j in self.slice.layer_ids],
                self._coerce(x), batch)

    def forward_q(self, buf, x, res, batch=None):
        """Mid-stage forward that emits a quantized boundary tensor: the
        forward, then K2 with error feedback on its output. ``res`` is the
        carried residual (None on the first send after an install).
        Returns ``(payload, res')``, ``payload`` a ``DeviceQuantized`` —
        or exact f32 values when the activation went non-finite (the
        residual then resets to zero)."""
        if self.last:
            raise ValueError("forward_q is for mid stages; the last stage "
                             "emits a loss, not an activation")
        return self._quantize(self.forward(buf, x, batch), res)

    def step(self, fwd_buf, new_buf, mom_buf, x, ct=None, batch=None):
        """One fused backward+update: recompute the forward under
        ``fwd_buf`` (the batch's vertical-sync version), backpropagate
        cotangent ``ct`` (implicit 1.0 at the last stage), and apply the
        SGD update to ``new_buf`` (the newest version). Returns new
        tensors ``(dx, new_buf', mom_buf')``."""
        x = self._coerce(x)
        if ct is not None:
            ct = self._coerce(ct)
        for j in self.slice.layer_ids:
            self.change_counts[j] += 1
        if self.compiled:
            return self._step_fused(fwd_buf, new_buf, mom_buf, x, ct, batch)
        return self._step_ref(fwd_buf, new_buf, mom_buf, x, ct, batch)

    def step_q(self, fwd_buf, new_buf, mom_buf, x, ct=None, batch=None,
               res=None):
        """``step`` that also quantizes the outgoing cotangent ``dx`` with
        error feedback (stages > 0 on the fused tier). Returns
        ``(payload, new_buf', mom_buf', res')`` with the same exact
        fallback as ``forward_q``."""
        dx, p_new, m_new = self.step(fwd_buf, new_buf, mom_buf, x, ct, batch)
        payload, res2 = self._quantize(dx, res)
        return payload, p_new, m_new, res2

    def _step_fused(self, fwd_buf, new_buf, mom_buf, x, ct, batch):
        # the VJP is taken on detached aliases: the stashed buffer itself
        # never gets requires_grad or a graph
        with torch.enable_grad():
            b = fwd_buf.detach().requires_grad_(True)
            xx = x.detach().requires_grad_(True)
            out = self._run([self.slice.unpack_layer(b, j)
                             for j in self.slice.layer_ids], xx, batch)
            g_buf, dx = torch.autograd.grad(
                out, (b, xx), grad_outputs=None if self.last else ct)
        p_new, m_new = fused_sgd(new_buf, g_buf, mom_buf, lr=self.lr,
                                 momentum=self.momentum,
                                 weight_decay=self.weight_decay)
        return dx, p_new, m_new

    def _step_ref(self, fwd_buf, new_buf, mom_buf, x, ct, batch):
        # per-layer autograd over unpacked dicts + leafwise sgd_update
        ids = self.slice.layer_ids
        with torch.enable_grad():
            plist = [tree.map(lambda t: t.detach().requires_grad_(True),
                              self.slice.unpack_layer(fwd_buf, j))
                     for j in ids]
            xx = x.detach().requires_grad_(True)
            out = self._run(plist, xx, batch)
            leaves = [l for p in plist for l in tree.leaves(p)]
            # materialize: an IR layer with t=1 carries an unused bn1,
            # whose gradient is zeros (as jax.vjp gives it)
            grads = torch.autograd.grad(
                out, leaves + [xx], grad_outputs=None if self.last else ct,
                allow_unused=True, materialize_grads=True)
        dx, off = grads[-1], 0
        new_flats, mom_flats = {}, {}
        for j, p in zip(ids, plist):
            paths = tree.flatten(p)[1]
            gp = tree.unflatten(paths, list(grads[off:off + len(paths)]))
            off += len(paths)
            p_new, st = sgd_update(
                self.slice.unpack_layer(new_buf, j), gp,
                {"momentum": self.slice.unpack_layer(mom_buf, j)},
                lr=self.lr, momentum=self.momentum,
                weight_decay=self.weight_decay)
            new_flats[j] = pack_leaves(tree.leaves(p_new))
            mom_flats[j] = pack_leaves(tree.leaves(st["momentum"]))
        return dx, self.slice.pack(new_flats), self.slice.pack(mom_flats)


_warm_lock = threading.Lock()


def warm_up(chain, batch: dict) -> None:
    """First CUDA use, done once before the live workers start: build the
    kernel library and run one forward and backward of the whole chain, so
    cuDNN/cuBLAS set-up and lazy kernel loading do not stall a worker's
    first segment past failure detection. The lock keeps two callers from
    building at once. A no-op for a chain on the CPU."""
    if chain.device.type != "cuda":
        return
    with _warm_lock:
        build.load("fused_sgd")
        build.load("quant")
        with torch.enable_grad():
            plist = [tree.map(lambda t: t.detach().requires_grad_(True), p)
                     for p in chain.params]
            loss = chain.loss_fn(plist, batch)
            torch.autograd.grad(loss, [l for p in plist
                                       for l in tree.leaves(p)],
                                allow_unused=True)
        synchronize(chain.device)
