"""MobileNetV2 (the paper's workload, §IV-B) as a partitionable layer chain,
in PyTorch. Counterpart of ``src/repro/models/mobilenet.py``; the same
layers, parameters and numbers.

Exposed as a *flat list of layers* — exactly what FTPipeHD's partition DP
and the live runtime operate on. CIFAR adaptation: 3x3/1 stem, first
stride-2 block de-strided (standard CIFAR MobileNetV2). BatchNorm uses
batch statistics (no running averages), as the runtime always trains.

Layouts follow the reference, so weights and activations carry over as
they are:
  * weights are HWIO (``[kh, kw, cin/groups, cout]``) in the parameter
    dicts and so in the flat buffers; they become OIHW only at the call;
  * layer-boundary tensors are NHWC (channels on the last axis, which the
    wire and the profile read). Inside a layer the NHWC tensor is seen as
    NCHW through ``permute``, which is PyTorch's channels-last layout, so
    cuDNN runs it without a copy;
  * ``"SAME"`` padding is XLA's: the odd pad goes to the high side, so a
    3x3 stride-2 conv on an even input pads (0, 1), not torch's (1, 1);
  * BatchNorm's variance is the biased one (``correction=0``), as
    ``jnp.var``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import tree

# (expansion t, out channels c, repeats n, stride s) — CIFAR variant
_IR_SPEC = [(1, 16, 1, 1), (6, 24, 2, 1), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
NUM_LAYERS = 2 + sum(n for _, _, n, _ in _IR_SPEC)   # stem + 17 IR + head = 19


def _conv_init(gen, kh, kw, cin, cout, groups=1):
    fan = kh * kw * cin // groups
    return torch.randn((kh, kw, cin // groups, cout),
                       generator=gen) / math.sqrt(fan)


def _bn_init(c):
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def _bn(p, x, eps=1e-5):
    """Train-mode BatchNorm over (N, H, W) of an NCHW view."""
    mu = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), keepdim=True, correction=0)
    return ((x - mu) * torch.rsqrt(var + eps) * p["scale"][:, None, None]
            + p["bias"][:, None, None])


def _same_pad(n, k, s):
    """XLA's SAME padding of one spatial axis: (low, high)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride=1, groups=1):
    """x: NCHW view, w: HWIO -> NCHW view."""
    kh, kw = w.shape[0], w.shape[1]
    if kh > 1 or kw > 1:
        top, bottom = _same_pad(x.shape[2], kh, stride)
        left, right = _same_pad(x.shape[3], kw, stride)
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride, groups=groups)


def init_layers(gen: torch.Generator, num_classes: int = 10,
                device="cpu"):
    """Returns (layers, meta): layers[i] = params dict, meta[i] = static
    info. Draws from ``gen`` (a CPU generator) so the weights are the same
    on every device and in every process for one seed."""
    layers, meta = [], []
    # stem
    layers.append({"w": _conv_init(gen, 3, 3, 3, 32), "bn": _bn_init(32)})
    meta.append({"kind": "stem", "cin": 3, "cout": 32, "stride": 1})
    cin = 32
    for t, c, n, s in _IR_SPEC:
        for i in range(n):
            stride = s if i == 0 else 1
            hid = cin * t
            p = {"bn1": _bn_init(hid), "bn2": _bn_init(hid), "bn3": _bn_init(c),
                 "w_dw": _conv_init(gen, 3, 3, hid, hid, groups=hid),
                 "w_proj": _conv_init(gen, 1, 1, hid, c)}
            if t != 1:
                p["w_exp"] = _conv_init(gen, 1, 1, cin, hid)
            layers.append(p)
            meta.append({"kind": "ir", "cin": cin, "cout": c, "stride": stride,
                         "t": t})
            cin = c
    # head: 1x1 conv to 1280 + pooled classifier
    layers.append({"w": _conv_init(gen, 1, 1, cin, 1280),
                   "bn": _bn_init(1280),
                   "fc_w": torch.randn((1280, num_classes), generator=gen)
                   * 0.01,
                   "fc_b": torch.zeros(num_classes)})
    meta.append({"kind": "head", "cin": cin, "cout": num_classes, "stride": 1})
    layers = [tree.map(lambda v: v.to(device), p) for p in layers]
    return layers, meta


def apply_layer(p, m, x):
    """Run one layer. x: NHWC feature map -> NHWC (logits after head)."""
    h = x.permute(0, 3, 1, 2)
    if m["kind"] == "stem":
        h = F.relu6(_bn(p["bn"], _conv(h, p["w"], m["stride"])))
        return h.permute(0, 2, 3, 1)
    if m["kind"] == "ir":
        x_nchw = h
        if "w_exp" in p:
            h = F.relu6(_bn(p["bn1"], _conv(h, p["w_exp"])))
        h = F.relu6(_bn(p["bn2"], _conv(h, p["w_dw"], m["stride"],
                                        groups=h.shape[1])))
        h = _bn(p["bn3"], _conv(h, p["w_proj"]))
        if m["stride"] == 1 and m["cin"] == m["cout"]:
            h = h + x_nchw
        return h.permute(0, 2, 3, 1)
    if m["kind"] == "head":
        h = F.relu6(_bn(p["bn"], _conv(h, p["w"])))
        h = h.mean(dim=(2, 3))
        return h @ p["fc_w"] + p["fc_b"]
    raise ValueError(m["kind"])


def forward(layers, meta, x):
    for p, m in zip(layers, meta):
        x = apply_layer(p, m, x)
    return x


def loss_fn(layers, meta, x, labels):
    logp = F.log_softmax(forward(layers, meta, x), dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def layer_flops(meta, image_hw: int = 32) -> list[float]:
    """Analytic per-layer forward FLOPs (for profiling/partitioning)."""
    out = []
    hw = image_hw
    for m in meta:
        if m["kind"] == "stem":
            f = 2 * 9 * m["cin"] * m["cout"] * hw * hw
        elif m["kind"] == "ir":
            hid = m["cin"] * m["t"]
            hw_out = hw // m["stride"]
            f = 2 * hw * hw * m["cin"] * hid            # expand
            f += 2 * 9 * hid * hw_out * hw_out          # depthwise
            f += 2 * hw_out * hw_out * hid * m["cout"]  # project
            hw = hw_out
        else:
            f = 2 * hw * hw * m["cin"] * 1280 + 2 * 1280 * m["cout"]
        out.append(float(f))
    return out


def output_sizes(meta, image_hw: int = 32, batch: int = 1) -> list[float]:
    """Per-layer output bytes (activation payload for the partition DP)."""
    out = []
    hw = image_hw
    for m in meta:
        hw = hw // m["stride"]
        if m["kind"] == "head":
            out.append(4.0 * batch * m["cout"])
        else:
            out.append(4.0 * batch * hw * hw * m["cout"])
    return out
