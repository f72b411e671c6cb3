"""Chain + global replication as a checkpointing layer (TPU-native mapping
of paper §III-E — see DESIGN.md §2).

Per-stage weight shards are replicated (a) to the next stage's slot
("chain": survives any single stage loss) and (b) to a global store
("global": survives arbitrary losses). ``recover_stage`` prefers the fresher
replica, exactly mirroring ``core.replication.ReplicaStore.recover``.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, Optional

import numpy as np

from repro_torch import tree
from repro_torch.checkpoint.manifest import _fsync_dir, atomic_write_json
from repro_torch.runtime.qtensor import host_array
from repro_torch.core.replication import chain_target, should_chain, should_global


def _copy_leaf(a: Any) -> Any:
    if hasattr(a, "detach"):
        return a.detach().clone()
    if isinstance(a, np.ndarray):
        return a.copy()
    return a


def _snapshot(weights: Any) -> Any:
    """A point-in-time copy of a stage's weights. The reference aliases
    its leaves, which is a copy there because jax arrays are immutable; a
    torch tensor can be written in place after the snapshot (the caller
    of ``maybe_replicate`` is free to), so tensor and numpy leaves are
    copied."""
    return tree.map(_copy_leaf, weights)


class ReplicatedCheckpointer:
    def __init__(self, num_stages: int, chain_every: int = 50,
                 global_every: int = 100):
        self.num_stages = num_stages
        self.chain_every = chain_every
        self.global_every = global_every
        self._chain: dict[int, tuple[int, Any]] = {}
        self._global: dict[int, tuple[int, Any]] = {}

    def maybe_replicate(self, batch: int, stage_weights: Callable[[int], Any]):
        """Call once per batch; snapshots per-stage weights on schedule.
        Returns (did_chain, did_global) for cost accounting."""
        did_c = should_chain(batch, self.chain_every)
        did_g = should_global(batch, self.global_every)
        if did_c:
            for s in range(self.num_stages):
                self._chain[s] = (batch, _snapshot(stage_weights(s)))
        if did_g:
            for s in range(self.num_stages):
                self._global[s] = (batch, _snapshot(stage_weights(s)))
        return did_c, did_g

    def recover_stage(self, stage: int,
                      lost_stages: set[int]) -> Optional[tuple[int, Any, str]]:
        holder = chain_target(stage, self.num_stages)
        if stage in self._chain and holder not in lost_stages:
            b, w = self._chain[stage]
            g = self._global.get(stage)
            if g is None or g[0] <= b:
                return b, w, "chain"
        if stage in self._global:
            b, w = self._global[stage]
            return b, w, "global"
        return None

    def latest_consistent_batch(self, lost_stages: set[int]) -> int:
        """Newest batch for which EVERY stage has a recoverable replica."""
        best = -1
        for s in range(self.num_stages):
            r = self.recover_stage(s, lost_stages)
            if r is None:
                return -1
            best = r[0] if best < 0 else min(best, r[0])
        return best


def _replica_nbytes(params: Any) -> int:
    return sum(int(l.nbytes) for l in tree.leaves(params)
               if hasattr(l, "nbytes"))


class LayerReplicaStore:
    """LAYER-keyed replica store for the live runtime (``runtime/live.py``).
    Stage-keyed stores (above) go stale the moment the partition moves;
    keying by layer makes replicas survive dynamic re-partition (§III-D)
    and worker-list renumbering (§III-F) — the redistribution planner's
    fallback targets always resolve.

    Snapshots arrive as packed flat f32 buffers (per-layer slices of a
    stage's contiguous weight buffer, ``runtime/stage_executor``), so a
    replica is one array, its wire size is exact (``nbytes``), and serving
    a §III-F fetch is a reference hand-off, not a pytree copy. The store is
    value-agnostic: legacy pytree snapshots still work.

    Replicas live in named TIERS matching the paper's two replication
    paths: ``"chain"`` (neighbor copies, §III-E) and ``"global"`` (central
    store) — ``tier`` defaults to ``"global"`` everywhere, so single-tier
    callers never see the distinction. A layer snapshotted at the same
    batch into both tiers is ONE logical replica held twice; ``nbytes()``
    therefore reports the DEDUPED total (each distinct ``(layer, batch)``
    snapshot counted once), ``nbytes(tier)`` the exact per-tier bytes, and
    ``nbytes_report()`` both plus the duplicated remainder. The old
    behavior — summing tiers blindly — double-counted exactly those
    shared snapshots (see ``docs/protocol.md``).
    """

    CHAIN = "chain"
    GLOBAL = "global"

    def __init__(self):
        self._tiers: dict[str, dict[int, tuple[int, Any]]] = {}

    def put(self, layer: int, batch: int, params: Any,
            tier: str = GLOBAL) -> None:
        """Keep the freshest snapshot per layer within ``tier``."""
        t = self._tiers.setdefault(tier, {})
        cur = t.get(layer)
        if cur is None or batch >= cur[0]:
            t[layer] = (batch, params)

    def put_many(self, batch: int, layers: dict, tier: str = GLOBAL) -> None:
        """Absorb one replication message ({layer -> packed weights})."""
        for j, p in layers.items():
            self.put(j, batch, p, tier)

    def refresh(self, batch: int, same: dict,
                tier: str = GLOBAL) -> list[int]:
        """Delta-plus-skip COMPARE-AND-STAMP (§III-E wire compression):
        ``same`` maps layer -> the batch the sender last shipped it into
        this tier. The sender verified those bytes are still its current
        snapshot, so bump the stored batch id to ``batch`` without any
        data on the wire — but ONLY where this store's stamp equals the
        sender's claim. Transports are best-effort: if the put the sender
        remembers never arrived (or this tier holds a fresher copy from
        someone else), the stamps mismatch and the entry is left alone —
        conservatively old rather than freshly mis-labeled. Layers the
        tier does not hold are ignored (never fabricate a replica).
        Returns the layer ids actually re-stamped."""
        t = self._tiers.setdefault(tier, {})
        done = []
        for j, prev in same.items():
            cur = t.get(j)
            if cur is not None and cur[0] == prev and batch >= cur[0]:
                t[j] = (batch, cur[1])
                done.append(j)
        return done

    def nbytes(self, tier: Optional[str] = None) -> int:
        """Stored replica bytes. With ``tier``: that tier's exact footprint.
        Without: the deduped logical total — each distinct (layer, batch)
        snapshot counted once even when both tiers hold it."""
        if tier is not None:
            return sum(_replica_nbytes(p)
                       for _, p in self._tiers.get(tier, {}).values())
        seen: dict[tuple[int, int], int] = {}
        for t in self._tiers.values():
            for layer, (batch, p) in t.items():
                seen.setdefault((layer, batch), _replica_nbytes(p))
        return sum(seen.values())

    def nbytes_report(self) -> dict:
        """{"per_tier": {tier -> bytes}, "deduped": int, "duplicated": int,
        "in_memory": int, "on_disk": int} where ``duplicated`` is the bytes
        a naive sum over tiers would over-report (snapshots present in more
        than one tier). ``in_memory``/``on_disk`` split the footprint by
        medium: the base store is memory-only (``on_disk`` = 0);
        ``DurableLayerReplicaStore`` overrides ``on_disk`` with its disk
        tier's indexed file bytes."""
        per_tier = {t: self.nbytes(t) for t in self._tiers}
        deduped = self.nbytes()
        return {"per_tier": per_tier, "deduped": deduped,
                "duplicated": sum(per_tier.values()) - deduped,
                "in_memory": deduped, "on_disk": 0}

    def has(self, layer: int, tier: Optional[str] = None) -> bool:
        """Whether any tier (or the given one) holds the layer."""
        tiers = [self._tiers.get(tier, {})] if tier is not None \
            else self._tiers.values()
        return any(layer in t for t in tiers)

    def get(self, layer: int,
            tier: Optional[str] = None) -> Optional[tuple[int, Any]]:
        """Freshest (batch, params) for the layer across tiers (or within
        ``tier``); None if absent."""
        tiers = [self._tiers.get(tier, {})] if tier is not None \
            else self._tiers.values()
        best = None
        for t in tiers:
            cur = t.get(layer)
            if cur is not None and (best is None or cur[0] > best[0]):
                best = cur
        return best

    def batches(self, tier: Optional[str] = None) -> dict[int, int]:
        """layer -> batch id of its freshest stored snapshot."""
        out: dict[int, int] = {}
        tiers = [self._tiers.get(tier, {})] if tier is not None \
            else self._tiers.values()
        for t in tiers:
            for layer, (b, _) in t.items():
                if layer not in out or b > out[layer]:
                    out[layer] = b
        return out

    def covers(self, num_layers: int, tier: Optional[str] = None) -> bool:
        """Every layer 0..num_layers-1 recoverable from the store."""
        return all(self.has(l, tier) for l in range(num_layers))


class DiskLayerTier:
    """Crash-consistent on-disk tier of per-layer slice files.

    Layout (one directory)::

        layer_00003.00000016.bin   raw bytes of layer 3's packed slice,
                                   snapshotted at batch 16 (tmp+rename)
        replicas.json              the INDEX: {layer -> {batch, file,
                                   dtype, shape}}, atomically replaced

    The index is the single source of truth: ``load()`` reads only files
    it names, so a SIGKILL mid-``put`` (a ``.bin`` written but not yet
    indexed, or a dangling ``.tmp``) leaves the previous committed state
    intact and the stray file is garbage-collected at the next ``sync()``.
    ``put`` stages an entry in memory; ``sync()`` — called at global
    replication points, before the manifest is written — fsyncs the staged
    files, replaces the index (fsync + rename + directory fsync), and GCs
    orphans. A delta-skip ``restamp`` only rewrites the index entry's
    batch stamp (the bytes on disk are verified-current by the sender), so
    the file name's embedded batch is a birth label, not authoritative.

    Values must be array-like (the live runtime's packed flat f32 slices);
    legacy pytree snapshots are not durable and stay memory-only."""

    INDEX = "replicas.json"

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(self.dir, exist_ok=True)
        self._index: dict[int, dict] = {}
        self._staged: dict[int, dict] = {}
        self._dirty = False
        path = os.path.join(self.dir, self.INDEX)
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
            self._index = {int(k): dict(v)
                           for k, v in doc.get("layers", {}).items()}

    def put(self, layer: int, batch: int, value: Any) -> None:
        arr = host_array(value)
        cur = self._staged.get(layer) or self._index.get(layer)
        if cur is not None and int(cur["batch"]) >= batch:
            return
        name = f"layer_{layer:05d}.{batch:08d}.bin"
        tmp = os.path.join(self.dir, name + ".tmp")
        with open(tmp, "wb") as f:
            f.write(np.ascontiguousarray(arr).tobytes())
        os.replace(tmp, os.path.join(self.dir, name))
        self._staged[layer] = {"batch": int(batch), "file": name,
                               "dtype": str(arr.dtype),
                               "shape": list(arr.shape)}
        self._dirty = True

    def restamp(self, layer: int, batch: int) -> None:
        """Delta-skip: the sender verified the stored bytes are still its
        current snapshot — advance the stamp without rewriting the file."""
        ent = self._staged.get(layer) or self._index.get(layer)
        if ent is not None and batch >= int(ent["batch"]):
            newe = dict(ent)
            newe["batch"] = int(batch)
            self._staged[layer] = newe
            self._dirty = True

    def sync(self) -> None:
        """Commit staged puts: fsync their files, atomically replace the
        index, GC unreferenced ``.bin``/``.tmp`` files."""
        if not self._dirty:
            return
        for ent in self._staged.values():
            path = os.path.join(self.dir, ent["file"])
            try:
                fd = os.open(path, os.O_RDONLY)
            except OSError:
                continue
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        self._index.update(self._staged)
        self._staged = {}
        atomic_write_json(
            os.path.join(self.dir, self.INDEX),
            {"layers": {str(k): v for k, v in self._index.items()}})
        live = {ent["file"] for ent in self._index.values()}
        for name in os.listdir(self.dir):
            if name.endswith((".bin", ".tmp")) and name not in live:
                try:
                    os.remove(os.path.join(self.dir, name))
                except OSError:
                    pass
        _fsync_dir(self.dir)
        self._dirty = False

    def load(self) -> dict[int, tuple[int, np.ndarray]]:
        """{layer -> (batch, array)} for every INDEXED snapshot; staged or
        orphaned files are invisible (they never committed)."""
        out: dict[int, tuple[int, np.ndarray]] = {}
        for layer, ent in self._index.items():
            path = os.path.join(self.dir, ent["file"])
            try:
                raw = open(path, "rb").read()
            except OSError:
                continue
            arr = np.frombuffer(raw, dtype=np.dtype(ent["dtype"]))
            out[layer] = (int(ent["batch"]),
                          arr.reshape([int(s) for s in ent["shape"]]))
        return out

    def batches(self) -> dict[int, int]:
        return {layer: int(ent["batch"])
                for layer, ent in self._index.items()}

    def nbytes(self) -> int:
        total = 0
        for ent in self._index.values():
            try:
                total += os.path.getsize(os.path.join(self.dir, ent["file"]))
            except OSError:
                pass
        return total


class DurableLayerReplicaStore(LayerReplicaStore):
    """``LayerReplicaStore`` whose GLOBAL tier is mirrored to a
    ``DiskLayerTier`` (ISSUE direction 4: the coordinator's central store
    must survive the coordinator). Construction replays the disk index
    into the in-memory GLOBAL tier, which is how a relaunched coordinator
    recovers every layer at the manifest's committed batch. Mirroring is
    write-through but commit is explicit: call ``sync()`` at replication
    points (the coordinator does, right before saving the manifest)."""

    def __init__(self, directory: str):
        super().__init__()
        self.disk = DiskLayerTier(directory)
        for layer, (batch, arr) in self.disk.load().items():
            super().put(layer, batch, arr, self.GLOBAL)

    def put(self, layer: int, batch: int, params: Any,
            tier: str = LayerReplicaStore.GLOBAL) -> None:
        super().put(layer, batch, params, tier)
        if tier == self.GLOBAL:
            try:
                self.disk.put(layer, batch, params)
            except (TypeError, ValueError):
                pass                    # non-array legacy value: memory-only

    def refresh(self, batch: int, same: dict,
                tier: str = LayerReplicaStore.GLOBAL) -> list[int]:
        done = super().refresh(batch, same, tier)
        if tier == self.GLOBAL:
            for j in done:
                self.disk.restamp(j, batch)
        return done

    def sync(self) -> None:
        self.disk.sync()

    def nbytes_report(self) -> dict:
        rep = super().nbytes_report()
        rep["on_disk"] = self.disk.nbytes()
        return rep
