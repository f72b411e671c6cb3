"""Partitionable layer-chain workloads for the live runtime, in PyTorch.

A ``LayerChain`` is the live counterpart of the simulator's
``WorkloadProfile``: a flat list of per-layer params + a per-layer apply
function — exactly the granularity FTPipeHD's partition DP
(``core/partition.py``) and redistribution plans (``core/redistribution.py``)
operate on. Stage i of the live pipeline owns a contiguous slice of the
chain and runs real forward/backward over it (``runtime/live.py``).

Constructors:
  * ``mobilenet_chain`` — the paper's workload (§IV-B), MobileNetV2/CIFAR
    from ``models/mobilenet.py``;
  * ``mlp_chain``       — a tiny dense chain for fast CI tests;
  * profiles are MEASURED on the central node (paper §III-B: "executes the
    model ten times and takes the average"), not assumed.

Layer params are dicts of tensors on the chain's ``device``. The port's own
init draws from a ``torch.Generator``, which cannot reproduce the
reference's ``jax.random`` draws; to run both packages on identical
weights, carry the reference's weights across with ``params_from_numpy``
or ``LayerChain.load_flat_params``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.runtime.devices import WorkloadProfile, resolve_device


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device``'s current stream (no-op on
    the CPU): the port's ``jax.block_until_ready`` before a clock read."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def as_f32(a, device) -> torch.Tensor:
    """A tensor, numpy array or wire-decoded array as an f32 tensor on
    ``device``. A tensor already there is returned as it is; host arrays
    are copied."""
    if torch.is_tensor(a):
        return a.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)


def params_from_numpy(params, device="cpu"):
    """Per-layer params as nested dicts of numpy arrays (for example the
    reference's ``jax.tree.map(np.asarray, chain.params)``) -> the same
    dicts of f32 tensors on ``device``, same shapes and layout."""
    return tree.map(lambda a: as_f32(a, device), params)


def _xent(y, batch):
    logp = F.log_softmax(y, dim=-1)
    return -logp.gather(1, batch["labels"].long()[:, None]).mean()


@dataclasses.dataclass
class LayerChain:
    """params[j] + apply(j, params_j, x) for a chain of L layers; the loss
    is computed on the last layer's output."""
    params: list
    apply_layer: Callable[[int, Any, Any], Any]     # (layer_idx, p, x) -> x
    loss: Callable[[Any, Any], Any]                 # (y_last, batch) -> scalar
    input_of: Callable[[dict], Any]                 # batch -> x0 (stage 0)
    device: torch.device = torch.device("cpu")
    _layout: Any = dataclasses.field(default=None, repr=False)

    @property
    def num_layers(self) -> int:
        return len(self.params)

    # ----------------------- packed flat views ---------------------------

    def flat_layout(self):
        """Packed-buffer layout of this chain (cached ``ChainLayout``) —
        derivable from the model definition alone, so every node agrees on
        it without exchanging metadata."""
        if self._layout is None:
            from repro_torch.runtime.stage_executor import ChainLayout
            self._layout = ChainLayout.of_params(self.params)
        return self._layout

    def flat_params(self, a: int = 0, e: int | None = None) -> dict:
        """{layer -> packed flat f32 weights} for layers [a, e]."""
        e = self.num_layers - 1 if e is None else e
        lay = self.flat_layout()
        return {j: lay.pack_layer(j, self.params[j]) for j in range(a, e + 1)}

    def flat_slice(self, a: int, e: int):
        """(SliceLayout, packed buffer) for the contiguous window [a, e] —
        the representation a live-runtime stage trains on."""
        lay = self.flat_layout().slice(a, e)
        return lay, lay.pack(self.flat_params(a, e))

    def load_flat_params(self, flats: dict) -> None:
        """Replace layer weights from {layer -> packed flat f32} (numpy
        arrays or tensors, in the shared packed layout) — how a test puts
        the reference's ``chain.flat_params()`` into the port."""
        lay = self.flat_layout()
        for j, flat in flats.items():
            self.params[j] = lay.unpack_layer(j, as_f32(flat, self.device))

    # ------------------- sequential oracle (no pipeline) -----------------

    def forward(self, params: list, x):
        for j, p in enumerate(params):
            x = self.apply_layer(j, p, x)
        return x

    def loss_fn(self, params: list, batch: dict):
        """Full-model loss over the flat layer list."""
        return self.loss(self.forward(params, self.input_of(batch)), batch)

    # --------------------------- profiling -------------------------------

    @torch.no_grad()
    def measure_profile(self, batch: dict, repeats: int = 3,
                        bwd_factor: float = 2.0) -> WorkloadProfile:
        """Central-node profile (paper §III-B): per-layer forward wall time
        (median of ``repeats``, the device synchronised before each clock
        read), activation payload from real shapes, weight payload from
        real leaves. Backward is priced at ``bwd_factor`` x forward (the
        usual fwd:bwd FLOP ratio) rather than timed per-layer."""
        x = self.input_of(batch)
        fwd, out_b = [], []
        for j, p in enumerate(self.params):
            ts = []
            for _ in range(repeats):
                synchronize(self.device)
                t0 = time.perf_counter()
                y = self.apply_layer(j, p, x)
                synchronize(self.device)
                ts.append(time.perf_counter() - t0)
            fwd.append(float(np.median(ts)))
            out_b.append(float(y.nbytes))
            x = y
        wb = [float(sum(a.nbytes for a in tree.leaves(p)))
              for p in self.params]
        fwd = np.asarray(fwd)
        return WorkloadProfile(fwd_times=fwd, bwd_times=bwd_factor * fwd,
                               out_bytes=np.asarray(out_b),
                               weight_bytes=np.asarray(wb))


# ------------------------------ constructors -----------------------------

@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Picklable recipe for a (chain, batches) pair, deterministic in the
    seed — every process that builds an equal spec gets the identical
    model and batch stream. ``kind`` selects the constructor below ("mlp"
    or "mobilenet")."""
    kind: str = "mlp"
    seed: int = 0
    num_layers: int = 8              # mlp depth (mobilenet is fixed at 19)
    width: int = 16                  # mlp hidden width
    in_dim: int = 8                  # mlp input features
    num_classes: int = 4             # mlp default; mobilenet uses 10
    num_data_batches: int = 8        # distinct batches, cycled over
    batch_size: int = 16
    noise: float = 0.3               # class-template noise scale (higher =
    #                                  harder task; Fig. 4 uses ~1.0)
    image_hw: int = 16               # mobilenet input resolution
    # Data-parallel fleet sharding: chain m of an M-chain fleet trains on
    # batches[shard_index::shard_count] — disjoint strided shards of the
    # same deterministic stream, identical model init (seed is shared).
    shard_index: int = 0
    shard_count: int = 1

    def shard(self, index: int, count: int) -> "WorkloadSpec":
        """This spec restricted to shard ``index`` of ``count`` (fleet
        chains): same model, disjoint slice of the batch stream."""
        assert 0 <= index < count, (index, count)
        return dataclasses.replace(self, shard_index=index,
                                   shard_count=count)

    def build(self, device=None) -> tuple[LayerChain, list]:
        """(chain, batches) on ``device`` (default CUDA; raises when there
        is none) — identical on every process for equal specs."""
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(self.seed)
        if self.kind == "mlp":
            chain = mlp_chain(gen, num_layers=self.num_layers,
                              width=self.width, in_dim=self.in_dim,
                              num_classes=self.num_classes, device=device)
            batches = classification_batches(
                "mlp", self.num_data_batches, batch=self.batch_size,
                seed=self.seed, in_dim=self.in_dim,
                num_classes=self.num_classes, noise=self.noise,
                device=device)
        elif self.kind == "mobilenet":
            chain = mobilenet_chain(gen, num_classes=10, device=device)
            batches = classification_batches(
                "mobilenet", self.num_data_batches, batch=self.batch_size,
                seed=self.seed, image_hw=self.image_hw, num_classes=10,
                device=device)
        else:
            raise ValueError(f"unknown workload kind {self.kind!r}")
        if self.shard_count > 1:
            batches = batches[self.shard_index::self.shard_count]
            if not batches:
                raise ValueError(
                    f"shard {self.shard_index}/{self.shard_count} of "
                    f"{self.num_data_batches} data batches is empty")
        return chain, batches


def mlp_chain(gen: torch.Generator, num_layers: int = 8, width: int = 16,
              in_dim: int = 8, num_classes: int = 4,
              device="cpu") -> LayerChain:
    """Dense tanh chain ending in a linear classifier head (layer L-1)."""
    device = torch.device(device)
    params = []
    for j in range(num_layers):
        d_in = in_dim if j == 0 else width
        d_out = num_classes if j == num_layers - 1 else width
        w = torch.randn((d_in, d_out), generator=gen) / np.sqrt(d_in)
        params.append({"w": w.to(device),
                       "b": torch.zeros(d_out, device=device)})

    def apply_layer(j, p, x):
        y = x @ p["w"] + p["b"]
        return y if j == num_layers - 1 else torch.tanh(y)

    return LayerChain(params=params, apply_layer=apply_layer, loss=_xent,
                      input_of=lambda b: b["x"], device=device)


def mobilenet_chain(gen: torch.Generator, num_classes: int = 10,
                    device="cpu") -> LayerChain:
    """The paper's MobileNetV2 (flat 19-layer chain, models/mobilenet.py)."""
    from repro_torch.models import mobilenet as mn
    device = torch.device(device)
    layers, meta = mn.init_layers(gen, num_classes=num_classes,
                                  device=device)

    def apply_layer(j, p, x):
        return mn.apply_layer(p, meta[j], x)

    return LayerChain(params=layers, apply_layer=apply_layer, loss=_xent,
                      input_of=lambda b: b["x"], device=device)


def classification_batches(chain_kind: str, num_batches: int, batch: int,
                           seed: int = 0, image_hw: int = 16,
                           in_dim: int = 8, num_classes: int = 4,
                           noise: float = 0.3, device="cpu"):
    """Deterministic learnable batches (class-template + noise), drawn from
    numpy exactly as the reference draws them, then placed on ``device``.
    Returns list of {"x" f32, "labels" int32} dicts."""
    rng = np.random.default_rng(seed)
    if chain_kind == "mlp":
        templates = rng.normal(0, 1, (num_classes, in_dim)).astype(np.float32)
    else:
        templates = rng.normal(
            0, 1, (num_classes, image_hw, image_hw, 3)).astype(np.float32)
    out = []
    for _ in range(num_batches):
        labels = rng.integers(0, num_classes, batch)
        x = templates[labels] + noise * rng.normal(
            0, 1, (batch,) + templates.shape[1:]).astype(np.float32)
        out.append({"x": torch.as_tensor(x.astype(np.float32), device=device),
                    "labels": torch.as_tensor(labels.astype(np.int32),
                                              device=device)})
    return out
