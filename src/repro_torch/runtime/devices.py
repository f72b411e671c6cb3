"""Device and workload descriptions for the edge-cluster simulator, and
the torch device the port computes on (``resolve_device``)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """One edge device. ``capacity`` is the paper's C_i: the multiplier on
    the central node's per-layer execution time (higher = slower).

    ``capacity_schedule``: ((batch, capacity), ...) — the device's capacity
    CHANGES at those batches (paper §I: "time-varying computing power"),
    e.g. thermal throttling or a background app."""
    name: str
    capacity: float = 1.0
    fails_at_batch: Optional[int] = None   # stops responding after this batch
    restarts: bool = False                 # paper case 2: restarts w/o state
    capacity_schedule: tuple = ()

    def capacity_at(self, batch: int) -> float:
        c = self.capacity
        for b, cap in self.capacity_schedule:
            if batch >= b:
                c = cap
        return c

    @staticmethod
    def paper_trio():
        """§IV-D: two MacBook-class devices + one ~10x-slower device."""
        return [DeviceSpec("macbook-0", 1.0),
                DeviceSpec("macbook-1", 1.0),
                DeviceSpec("desktop-slow", 10.0)]

    @staticmethod
    def raspberry_trio():
        return [DeviceSpec(f"rpi-{i}", 1.0) for i in range(3)]


@dataclasses.dataclass
class WorkloadProfile:
    """Per-layer profile measured by the central node (paper §III-B:
    'executes the model ten times and takes the average')."""
    fwd_times: np.ndarray            # [L] seconds on the central node
    bwd_times: np.ndarray            # [L]
    out_bytes: np.ndarray            # [L] activation payload D_j
    weight_bytes: np.ndarray         # [L] parameter payload per layer

    def __post_init__(self):
        self.fwd_times = np.asarray(self.fwd_times, float)
        self.bwd_times = np.asarray(self.bwd_times, float)
        self.out_bytes = np.asarray(self.out_bytes, float)
        self.weight_bytes = np.asarray(self.weight_bytes, float)

    @property
    def num_layers(self) -> int:
        return len(self.fwd_times)

    @property
    def exec_times(self) -> np.ndarray:
        """T_e,j^0 = forward + backward per layer (paper §III-B)."""
        return self.fwd_times + self.bwd_times

    @staticmethod
    def mobilenetv2(batch: int = 256, image_hw: int = 32,
                    central_flops_per_s: float = 2e10) -> "WorkloadProfile":
        import torch
        from repro_torch import tree
        from repro_torch.models import mobilenet as mn
        layers, meta = mn.init_layers(torch.Generator().manual_seed(0))
        fl = np.asarray(mn.layer_flops(meta, image_hw)) * batch
        fwd = fl / central_flops_per_s
        out_b = np.asarray(mn.output_sizes(meta, image_hw, batch))
        # rough per-layer weight bytes
        wb = np.asarray([sum(l.numel() * 4 for l in tree.leaves(p))
                         for p in layers], float)
        return WorkloadProfile(fwd_times=fwd, bwd_times=2 * fwd,
                               out_bytes=out_b, weight_bytes=wb)


def uniform_bandwidth(n: int, bytes_per_s: float = 10e6 / 8 * 8):
    """n x n symmetric bandwidth matrix (default ~10 MB/s WiFi-class)."""
    B = np.full((n, n), float(bytes_per_s))
    np.fill_diagonal(B, np.inf)
    return B


def resolve_device(device=None):
    """The torch device an entry point computes on: ``"cuda"`` unless the
    caller names another. Raises when CUDA is asked for (or implied) and
    there is none: nothing runs on the CPU unless the caller says so."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev
