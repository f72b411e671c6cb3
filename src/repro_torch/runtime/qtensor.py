"""Device-quantized tensor container for the zero-copy wire path.

A ``DeviceQuantized`` is what ``StageExecutor.forward_q``/``step_q``
emit: u8 codes plus per-channel affine params, produced on the device
by ``kernels/quant``. The fields are raw ``bytes`` so the
codec can frame them with pure struct-packing — no numpy pass on the
transport hot path (``tools/check_codec_hotpath.py`` enforces that).
The numpy conversions live HERE, at construction (one memcpy off the
device) and at consumption (``arrays()``/``to_f32()``), never per-send
inside ``codec.encode``.

Semantics match ``kernels/quant``: channel = last axis,
``x ≈ lo[c] + scale[c] * q[..., c]``, and ``scale[c] == 0`` marks a
degenerate channel that decodes to exactly ``lo[c]``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


def host_array(x) -> np.ndarray:
    """``x`` as a host numpy array. A torch tensor (on any device) is
    detached and copied to the host first: ``np.asarray`` refuses a CUDA
    tensor, and one that requires grad."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass(frozen=True)
class DeviceQuantized:
    """u8-quantized ndarray + per-channel affine params, as raw bytes.

    ``shape``: logical f32 shape (channel = last axis);
    ``data``: u8 codes, C-order, ``prod(shape)`` bytes;
    ``lo``/``scale``: f32 little-endian per-channel params, 4*C bytes
    each where ``C = shape[-1]``.
    """

    shape: tuple
    data: bytes
    lo: bytes
    scale: bytes

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(d) for d in self.shape))
        if not self.shape:
            raise ValueError("DeviceQuantized requires rank >= 1")
        n = math.prod(self.shape)
        C = self.shape[-1]
        if len(self.data) != n:
            raise ValueError(f"DeviceQuantized: {len(self.data)} code bytes "
                             f"for shape {self.shape} (want {n})")
        if len(self.lo) != 4 * C or len(self.scale) != 4 * C:
            raise ValueError(f"DeviceQuantized: lo/scale bytes "
                             f"({len(self.lo)}/{len(self.scale)}) do not "
                             f"match {C} channels")

    @classmethod
    def from_arrays(cls, q, lo, scale) -> "DeviceQuantized":
        """Pack kernel outputs (u8 codes, f32 lo/scale) into wire bytes."""
        q = np.ascontiguousarray(host_array(q), dtype=np.uint8)
        lo = np.ascontiguousarray(host_array(lo), dtype="<f4")
        scale = np.ascontiguousarray(host_array(scale), dtype="<f4")
        return cls(q.shape, q.tobytes(), lo.tobytes(), scale.tobytes())

    @property
    def nbytes(self) -> int:
        # Counted by transport byte accounting (Message.payload_bytes).
        return len(self.data) + len(self.lo) + len(self.scale)

    @property
    def num_channels(self) -> int:
        return self.shape[-1]

    def arrays(self):
        """Zero-copy numpy views ``(q [..., C] u8, lo [C] f32,
        scale [C] f32)`` — what ``StageExecutor`` feeds the fused
        dequantize kernel."""
        q = np.frombuffer(self.data, np.uint8).reshape(self.shape)
        lo = np.frombuffer(self.lo, "<f4")
        scale = np.frombuffer(self.scale, "<f4")
        return q, lo, scale

    def to_f32(self) -> np.ndarray:
        """Host-side dequantize (numpy) — for consumers without a
        ``StageExecutor`` (tests, reports). The compiled path uses
        ``kernels/quant.dequantize`` instead."""
        q, lo, scale = self.arrays()
        return (lo + scale * q.astype(np.float32)).astype(np.float32)
