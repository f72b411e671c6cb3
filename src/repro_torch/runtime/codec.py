"""Wire codec for the live FTPipeHD runtime: every transport payload to and
from ``bytes``.

The in-process queue transport could ship raw Python objects forever; a
socket or multi-process transport cannot. This module defines the wire
format and proves — when ``Transport(codec=True)`` round-trips every
message through it — that the whole live protocol is serialization-clean:
no closures, no shared references, nothing that would not survive a real
network hop.

Format (little-endian, no external deps, NOT pickle — decoding never
executes code):

    b"FTPH" | version u8 | kind: u16 len + utf8 | value

with tagged values: None/bool, i64, f64, str/bytes (u32 len), list/tuple
(u32 count), dict (u32 count, key-value pairs, int or str keys), and
ndarray (dtype name, u8 ndim, u32 dims, raw row-major data). Torch tensors
are copied to the host (``qtensor.host_array``) and decode as NumPy arrays
(``StageExecutor._coerce`` moves them back to the device); NumPy scalars
collapse to Python
int/float/bool. ``payload_bytes`` in ``runtime/transport.py`` counts array
bytes only; ``len(encode(...))`` is the exact wire size including framing.

Codec v2 adds two COMPRESSED ndarray encodings, selected per message by a
``tier`` (AccEPT-style quantized activation communication):

  * ``fp16``  — f32 tensors cast to IEEE half precision (2 bytes/elem),
  * ``int8``  — per-tensor affine quantization (1 byte/elem + an 8-byte
    ``(min, scale)`` header): ``x ≈ min + scale * q`` with
    ``scale = (max - min) / 255``.

Both tags are SELF-DESCRIBING: ``decode`` dequantizes back to f32 with no
out-of-band state, so any endpoint can decode any tier and the compiled
``runtime/stage_executor.py`` step always sees f32. The encoder falls back
to the exact f32 tag per tensor whenever compression would lose more than
quantization noise: non-f32 dtypes, zero-length arrays, tensors with
non-finite values (NaN/inf), fp16 overflow (|x| > 65504), and degenerate
ranges (max == min). Which tier a sender uses per message KIND is a
``WirePolicy`` (data plane / §III-E replica traffic / control, the last
always exact); the policy is config-carried and confirmed by the
coordinator in the ``install``/``admit`` handshake (``docs/protocol.md``).

Codec v3 adds the DEVICE-QUANTIZED ndarray tag (13): the payload is a
``runtime/qtensor.DeviceQuantized`` — u8 codes + per-channel affine
params produced on the device at the ``StageExecutor`` boundary by the
fused ``kernels/quant`` CUDA kernels (with error-feedback residuals
carried on-device). Unlike tags 11/12, the codec performs NO quantization math in
either direction: ``encode`` frames the already-quantized bytes with pure
struct-packing (zero numpy passes — enforced by
``tools/check_codec_hotpath.py``), and ``decode`` returns the
``DeviceQuantized`` container itself, handing dequantization to the
receiving ``StageExecutor`` (fused kernel, on-device) or the consumer's
explicit ``to_f32()``. The ``int8-fused`` tier selects this path; plain
f32 ndarrays under that tier fall back to tag 12 (so replica snapshots
still compress).

``runtime/net.py`` ships exactly these bytes across process boundaries
(one message per length-prefixed TCP frame); the full byte-level spec,
including the frame header, lives in ``docs/protocol.md``.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Any, Optional

import numpy as np

from repro_torch.runtime.qtensor import DeviceQuantized, host_array

MAGIC = b"FTPH"
VERSION = 3                  # v2 = compressed tags (11/12); v3 = tag 13
DECODABLE_VERSIONS = (1, 2, 3)

_NONE, _TRUE, _FALSE, _INT, _FLOAT = 0, 1, 2, 3, 4
_STR, _BYTES, _LIST, _TUPLE, _DICT, _ARRAY = 5, 6, 7, 8, 9, 10
_ARRAY_F16, _ARRAY_Q8, _ARRAY_QD = 11, 12, 13

TIERS = ("off", "fp16", "int8", "int8-fused")

# message-kind classes a WirePolicy assigns tiers to (docs/protocol.md §3)
DATA_KINDS = frozenset({"act", "grad"})          # activations + cotangents
# §III-E snapshots. The ov_ variants are the overlap scheduler's deferred
# shipments (identical payload + store semantics, sent during the next
# segment's compute instead of inside the control-point drain) — a
# distinct wire kind so transport stats can attribute the overlapped
# bytes separately (transport.KIND_CLASSES "replica_ov").
REPLICA_KINDS = frozenset({"chain_put", "global_put",
                           "ov_chain_put", "ov_global_put"})

# data-plane kinds covered by the transports' seq/ack retransmit window
# (docs/protocol.md §7): a reliable sender wraps the payload as
# {"_seq": n, "_era": e, "body": payload} and the receiver answers with
# batched CUMULATIVE ACK_KIND frames carrying {"era", "floor", "seqs"}.
# Acks are themselves best-effort (an unacked frame is simply
# retransmitted) and are consumed at the transport layer — worker code
# never sees them.
RELIABLE_KINDS = frozenset(DATA_KINDS)
ACK_KIND = "ack"


@dataclasses.dataclass(frozen=True)
class WirePolicy:
    """Compression tier per message class. ``data`` covers the 1F1B data
    plane (``act``/``grad``); ``replica`` the §III-E replication snapshots
    (``chain_put``/``global_put``). Everything else — control commands,
    and crucially the §III-F weight-redistribution payloads
    (``install``/``fetch_res``) — is ALWAYS exact f32: recovery must
    restore the weights that were trained, not a re-quantized copy.

    Decode is self-describing, so the policy only governs what a sender
    emits; mixed-policy endpoints interoperate. The coordinator's policy
    is authoritative: it ships in the ``install``/``admit`` handshake and
    remote workers adopt it (see ``runtime/live.py``)."""
    data: str = "off"
    replica: str = "off"

    def __post_init__(self):
        for t in (self.data, self.replica):
            if t not in TIERS:
                raise ValueError(f"unknown wire tier {t!r} (one of {TIERS})")

    def tier_for(self, kind: str) -> str:
        if kind in DATA_KINDS:
            return self.data
        if kind in REPLICA_KINDS:
            return self.replica
        return "off"

    def any_compression(self) -> bool:
        return self.data != "off" or self.replica != "off"

    def to_payload(self) -> dict:
        """Wire form for the install/admit handshake."""
        return {"data": self.data, "replica": self.replica}

    @classmethod
    def from_payload(cls, d: dict) -> "WirePolicy":
        return cls(data=d.get("data", "off"), replica=d.get("replica", "off"))


def _enc_array(x: Any, out: list, tier: str, used: list) -> None:
    """One ndarray value: compressed per ``tier`` when safe, else the
    exact f32/any-dtype tag (the per-tensor fallback rule — see module
    docstring and docs/protocol.md §1b). ``used[0]`` tracks the highest
    codec level any emitted tag requires (drives the frame version).

    ``int8-fused`` reaching HERE means the sender shipped a plain f32
    ndarray under the fused tier (replica snapshots, or a stage's exact
    non-finite fallback): replica arrays take the tag-12 path; exact
    fallbacks are non-finite and hit the exact-tag fallback below."""
    if tier == "int8-fused":
        tier = "int8"
    arr = np.ascontiguousarray(host_array(x))
    if tier != "off" and arr.dtype == np.float32 and arr.size:
        dims = struct.pack(f"<{arr.ndim}I", *arr.shape)
        if tier == "fp16":
            with np.errstate(over="ignore"):    # overflow = fallback, below
                f16 = arr.astype(np.float16)
            # finite f16 result implies finite f32 input AND no overflow
            if np.isfinite(f16).all():
                used[0] = max(used[0], 2)
                out.append(bytes([_ARRAY_F16, arr.ndim]) + dims
                           + f16.tobytes())
                return
        elif tier == "int8":
            lo, hi = float(arr.min()), float(arr.max())
            # quantize against the f32-rounded (lo, scale) that will
            # actually be stored, so the round-trip error bound
            # (scale / 2) holds exactly. The degenerate-range guard is on
            # the STORED scale: a subnormal range can pass hi > lo in
            # f64 yet underflow scale32 to 0 (divide-by-NaN, and every
            # element would decode to lo) — that is a fallback too.
            lo32 = np.float32(lo)
            scale32 = np.float32((hi - lo) / 255.0)
            if np.isfinite(lo) and np.isfinite(hi) and np.isfinite(scale32) \
                    and float(scale32) > 0.0:
                q = np.clip(np.rint((arr - lo32) / scale32),
                            0, 255).astype(np.uint8)
                used[0] = max(used[0], 2)
                out.append(bytes([_ARRAY_Q8, arr.ndim]) + dims
                           + struct.pack("<ff", lo32, scale32)
                           + q.tobytes())
                return
    name = str(arr.dtype).encode("ascii")
    out.append(bytes([_ARRAY, len(name)]) + name + bytes([arr.ndim])
               + struct.pack(f"<{arr.ndim}I", *arr.shape)
               + arr.tobytes())


def _enc_qd(x: DeviceQuantized, out: list, used: list) -> None:
    """Zero-copy passthrough of a device-quantized tensor (tag 13). The
    payload was quantized on the device already; this function is pure
    struct-packing + byte concatenation by design — no numpy calls on
    the data-plane hot path (tools/check_codec_hotpath.py enforces it).

    Layout: tag u8 | ndim u8 | dims u32*ndim | C u32 | lo f32*C |
    scale f32*C | codes u8*prod(dims), with C = dims[-1]."""
    used[0] = max(used[0], 3)
    ndim = len(x.shape)
    out.append(bytes([_ARRAY_QD, ndim])
               + struct.pack(f"<{ndim}I", *x.shape)
               + struct.pack("<I", x.num_channels))
    out.append(x.lo)
    out.append(x.scale)
    out.append(x.data)


def _enc(x: Any, out: list, tier: str = "off",
         used: Optional[list] = None) -> None:
    if used is None:
        used = [1]
    if x is None:
        out.append(bytes([_NONE]))
    elif isinstance(x, (bool, np.bool_)):
        out.append(bytes([_TRUE if x else _FALSE]))
    elif isinstance(x, (int, np.integer)):
        out.append(bytes([_INT]) + struct.pack("<q", int(x)))
    elif isinstance(x, (float, np.floating)):
        out.append(bytes([_FLOAT]) + struct.pack("<d", float(x)))
    elif isinstance(x, str):
        b = x.encode("utf-8")
        out.append(bytes([_STR]) + struct.pack("<I", len(b)) + b)
    elif isinstance(x, bytes):
        out.append(bytes([_BYTES]) + struct.pack("<I", len(x)) + x)
    elif isinstance(x, (list, tuple)):
        out.append(bytes([_TUPLE if isinstance(x, tuple) else _LIST])
                   + struct.pack("<I", len(x)))
        for v in x:
            _enc(v, out, tier, used)
    elif isinstance(x, dict):
        out.append(bytes([_DICT]) + struct.pack("<I", len(x)))
        for k, v in x.items():
            _enc(k, out, tier, used)
            _enc(v, out, tier, used)
    elif isinstance(x, DeviceQuantized):                # pre-quantized, tag 13
        _enc_qd(x, out, used)
    elif hasattr(x, "shape") and hasattr(x, "dtype"):   # ndarray / tensor
        _enc_array(x, out, tier, used)
    else:
        raise TypeError(f"codec cannot encode {type(x).__name__}: {x!r}")


def _need(buf: bytes, off: int, n: int, what: str) -> None:
    """Truncation guard for the array decode paths: a clear error instead
    of whatever ``np.frombuffer``/``struct`` would raise on a short
    buffer."""
    if len(buf) - off < n:
        raise ValueError(f"codec: truncated {what} — need {n} bytes at "
                         f"offset {off}, have {len(buf) - off}")


def _dec_qd(buf: bytes, off: int) -> tuple[DeviceQuantized, int]:
    """Tag-13 decode: pure byte slicing into a ``DeviceQuantized`` — the
    receiving StageExecutor dequantizes on-device (or the consumer calls
    ``to_f32()``); no numpy pass here."""
    _need(buf, off, 1, "device-quantized header")
    ndim = buf[off]
    off += 1
    if ndim < 1:
        raise ValueError("codec: device-quantized array requires rank >= 1")
    _need(buf, off, 4 * ndim + 4, "device-quantized header")
    shape = struct.unpack_from(f"<{ndim}I", buf, off)
    off += 4 * ndim
    (C,) = struct.unpack_from("<I", buf, off)
    off += 4
    if C != shape[-1]:
        raise ValueError(f"codec: device-quantized channel count {C} does "
                         f"not match shape {shape}")
    count = 1
    for d in shape:
        count *= d
    _need(buf, off, 8 * C + count, "device-quantized payload")
    lo = buf[off:off + 4 * C]
    off += 4 * C
    scale = buf[off:off + 4 * C]
    off += 4 * C
    data = buf[off:off + count]
    return DeviceQuantized(shape, data, lo, scale), off + count


def _dec(buf: bytes, off: int) -> tuple[Any, int]:
    tag = buf[off]
    off += 1
    if tag == _NONE:
        return None, off
    if tag == _TRUE:
        return True, off
    if tag == _FALSE:
        return False, off
    if tag == _INT:
        return struct.unpack_from("<q", buf, off)[0], off + 8
    if tag == _FLOAT:
        return struct.unpack_from("<d", buf, off)[0], off + 8
    if tag in (_STR, _BYTES):
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        raw = buf[off:off + n]
        return (raw.decode("utf-8") if tag == _STR else raw), off + n
    if tag in (_LIST, _TUPLE):
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        items = []
        for _ in range(n):
            v, off = _dec(buf, off)
            items.append(v)
        return (tuple(items) if tag == _TUPLE else items), off
    if tag == _DICT:
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        d = {}
        for _ in range(n):
            k, off = _dec(buf, off)
            v, off = _dec(buf, off)
            d[k] = v
        return d, off
    if tag == _ARRAY:
        nlen = buf[off]
        off += 1
        dtype = np.dtype(buf[off:off + nlen].decode("ascii"))
        off += nlen
        ndim = buf[off]
        off += 1
        _need(buf, off, 4 * ndim, "array header")
        shape = struct.unpack_from(f"<{ndim}I", buf, off)
        off += 4 * ndim
        count = int(np.prod(shape, dtype=np.int64)) if ndim else 1
        nbytes = count * dtype.itemsize
        _need(buf, off, nbytes, f"{dtype} array data")
        arr = np.frombuffer(buf, dtype, count=count,
                            offset=off).reshape(shape)
        return arr, off + nbytes
    if tag in (_ARRAY_F16, _ARRAY_Q8):
        # self-describing compressed f32 tensors: dequantize HERE, so the
        # consumer (and the compiled StageExecutor step) always sees f32
        ndim = buf[off]
        off += 1
        _need(buf, off, 4 * ndim, "array header")
        shape = struct.unpack_from(f"<{ndim}I", buf, off)
        off += 4 * ndim
        count = int(np.prod(shape, dtype=np.int64)) if ndim else 1
        if tag == _ARRAY_F16:
            _need(buf, off, 2 * count, "fp16 array data")
            arr = np.frombuffer(buf, np.float16, count=count,
                                offset=off).reshape(shape)
            return arr.astype(np.float32), off + 2 * count
        _need(buf, off, 8 + count, "int8 array data")
        lo, scale = struct.unpack_from("<ff", buf, off)
        off += 8
        q = np.frombuffer(buf, np.uint8, count=count,
                          offset=off).reshape(shape)
        return (lo + scale * q).astype(np.float32), off + count
    if tag == _ARRAY_QD:
        return _dec_qd(buf, off)
    raise ValueError(f"codec: unknown tag {tag} at offset {off - 1}")


def encode(kind: str, payload: Any, tier: str = "off") -> bytes:
    """One framed wire message. ``tier`` selects the ndarray compression
    ("off" | "fp16" | "int8" | "int8-fused") applied to every eligible
    f32 tensor in the payload; ineligible tensors fall back to the exact
    f32 tag per tensor (see ``_enc_array``), and ``DeviceQuantized``
    payloads pass through zero-copy as tag 13 regardless of tier.
    Decoding needs no tier — the tags are self-describing. The version
    byte is stamped with the HIGHEST codec level any emitted tag
    requires: 1 (no compressed tags — byte-identical to codec v1, so a
    v1-only decoder keeps understanding every uncompressed message), 2
    (tags 11/12), or 3 (tag 13)."""
    if tier not in TIERS:
        raise ValueError(f"unknown wire tier {tier!r} (one of {TIERS})")
    k = kind.encode("utf-8")
    out = [MAGIC, b"\x00", struct.pack("<H", len(k)), k]
    used = [1]
    _enc(payload, out, tier, used)
    out[1] = bytes([used[0]])
    return b"".join(out)


def decode(data: bytes) -> tuple[str, Any]:
    """Inverse of ``encode``. Raises ValueError on framing errors."""
    if data[:4] != MAGIC:
        raise ValueError("codec: bad magic")
    if data[4] not in DECODABLE_VERSIONS:
        raise ValueError(f"codec: unsupported version {data[4]}")
    (klen,) = struct.unpack_from("<H", data, 5)
    kind = data[7:7 + klen].decode("utf-8")
    payload, off = _dec(data, 7 + klen)
    if off != len(data):
        raise ValueError(f"codec: {len(data) - off} trailing bytes")
    return kind, payload
