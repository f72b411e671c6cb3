"""Resumable run manifest (the durable control plane's source of truth).

A live run with ``run_dir`` set persists a small JSON document next to
the disk replica tier, rewritten atomically at every global replication
point (docs/protocol.md §8):

* ``config`` — the full ``run.RunConfig`` serialization (workload spec,
  live/protocol settings, transport kind, wire policy), enough to rebuild
  the identical chain, batch stream, and cluster shape in a fresh
  process;
* ``state`` — what the coordinator learned while running: the last
  COMMITTED batch (the newest batch whose update every layer's disk
  replica has absorbed — a resume restarts at ``last_committed + 1``),
  the partition in force, live worker ids, per-device
  incarnations (PR 4 epoch fencing), the node -> (host, port) routing
  table for TCP runs, and the wire policy actually in force.

``last_committed`` is -1 until the first global replication lands — a
resume from such a manifest is just a fresh start. The manifest is
written via write-to-temp + fsync + ``os.replace`` + directory fsync, so
a SIGKILL mid-write leaves either the old or the new document, never a
torn one; the disk tier's index uses the same discipline, and the
manifest is written AFTER the tier's ``sync()``, so the batch it names is
always fully recoverable.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

MANIFEST_NAME = "manifest.json"


def _fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed file survives power loss."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_json(path: str, doc: dict) -> None:
    """Crash-consistent JSON write: temp file + fsync + rename + dir fsync."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))


@dataclasses.dataclass
class RunManifest:
    """One resumable run: ``config`` rebuilds the run, ``state`` says how
    far it got. Both are plain-JSON dicts (see module docstring)."""

    config: dict
    state: dict
    version: int = 1

    @property
    def last_committed(self) -> int:
        """Newest batch fully covered by the disk replica tier; -1 when
        no global replication point has committed yet."""
        return int(self.state.get("last_committed", -1))

    def to_doc(self) -> dict:
        return {"version": self.version, "config": self.config,
                "state": self.state}

    @staticmethod
    def from_doc(doc: dict) -> "RunManifest":
        if int(doc.get("version", 0)) != 1:
            raise ValueError(
                f"unsupported manifest version {doc.get('version')!r}")
        return RunManifest(config=dict(doc.get("config", {})),
                           state=dict(doc.get("state", {})),
                           version=1)

    def save(self, directory: str) -> str:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, MANIFEST_NAME)
        atomic_write_json(path, self.to_doc())
        return path

    @staticmethod
    def load(directory: str) -> "RunManifest":
        path = os.path.join(directory, MANIFEST_NAME)
        with open(path, encoding="utf-8") as f:
            return RunManifest.from_doc(json.load(f))

    @staticmethod
    def try_load(directory: str) -> Optional["RunManifest"]:
        """Load if present and readable, else None (poll-friendly: a
        concurrent atomic save never yields a torn read, only old/new)."""
        try:
            return RunManifest.load(directory)
        except (OSError, ValueError):
            return None


FLEET_MANIFEST_NAME = "fleet.json"


@dataclasses.dataclass
class FleetManifest:
    """Fleet-level sibling of ``RunManifest``: one ``fleet.json`` at the
    fleet's ``run_dir`` root describing the data axis — the
    ``run.RunConfig.fleet`` block (``config``) plus the supervisor's view
    (``state``: live chains, published aggregation rounds, per-chain
    incarnation counts). Each CHAIN keeps its own full ``RunManifest``
    under ``run_dir/chain<i>/`` exactly as a single-chain run would, so
    chain-level resume machinery is untouched; fleet-level resume (replay
    this document) is future work and the version field gates it."""

    config: dict
    state: dict
    version: int = 1

    def to_doc(self) -> dict:
        return {"version": self.version, "config": self.config,
                "state": self.state}

    @staticmethod
    def from_doc(doc: dict) -> "FleetManifest":
        if int(doc.get("version", 0)) != 1:
            raise ValueError(
                f"unsupported fleet manifest version {doc.get('version')!r}")
        return FleetManifest(config=dict(doc.get("config", {})),
                             state=dict(doc.get("state", {})),
                             version=1)

    def write(self, directory: str) -> str:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, FLEET_MANIFEST_NAME)
        atomic_write_json(path, self.to_doc())
        return path

    @staticmethod
    def try_load(directory: str) -> Optional["FleetManifest"]:
        try:
            path = os.path.join(directory, FLEET_MANIFEST_NAME)
            with open(path, encoding="utf-8") as f:
                return FleetManifest.from_doc(json.load(f))
        except (OSError, ValueError):
            return None
