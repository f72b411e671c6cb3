"""Deterministic per-link network emulation (WAN shaping) for both
transports.

FTPipeHD lives on slow, asymmetric, lossy edge links, but the transports
by themselves model *reachability* only (``runtime/transport.py``). This
module adds the missing link model as a layer UNDER either transport:

  * ``LinkSpec``  — one directed link's shape: one-way ``latency`` with
    bounded ``jitter``, token-bucket bandwidth (``rate`` bytes/s with a
    ``burst`` allowance), Bernoulli ``loss``, and timed ``partitions``
    (windows, in seconds since the shaper started, during which the link
    is down entirely);
  * ``NetemSpec`` — the cluster's link map: a ``default`` LinkSpec, per
    ``(src, dst)`` overrides, the RNG ``seed``, and ``colocated`` node
    groups whose internal traffic is never shaped (the coordinator and
    worker 0 share a process/host, so COORD<->0 is a local bus by
    default);
  * ``LinkShaper`` — the runtime: ``admit(src, dst, nbytes)`` prices one
    message and returns its delivery delay (or ``None`` = the link
    dropped it), and a single daemon ``_Scheduler`` thread delivers every
    delayed message of the whole transport — replacing the old
    one-``threading.Timer``-per-message ``FaultSpec.delay`` hack.

Determinism: loss and jitter draw from a per-link ``random.Random``
seeded by ``(seed, src, dst)``, so given the same per-link message
sequence every drop decision and jitter draw repeats exactly — on either
transport. Ordering: arrivals are clamped monotone per link, so shaping
never reorders a link's messages (FIFO links, like a TCP stream or a
radio channel), and the scheduler breaks due-time ties by submission
order.

Token bucket: a link with ``rate`` > 0 serializes bytes at ``rate``; up
to ``burst`` bytes of idle credit accumulate, so short messages after a
quiet period pass latency-only. The measured throughput of a saturated
link converges on ``rate`` from below (validated within 20% in
``benchmarks/bench_wan_validation.py``).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import random
import threading
import time
from typing import Callable, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """Shape of ONE directed link. All fields off (0) = transparent."""
    latency: float = 0.0      # one-way delay, seconds
    jitter: float = 0.0       # uniform +/- bound added to latency, seconds
    rate: float = 0.0         # token-bucket bandwidth, bytes/s (0 = infinite)
    burst: int = 64 << 10     # token-bucket depth, bytes
    loss: float = 0.0         # Bernoulli drop probability per message
    partitions: Tuple[Tuple[float, float], ...] = ()
    #                         # (start_s, end_s) windows (shaper clock)
    #                         # during which the link drops EVERYTHING

    def is_transparent(self) -> bool:
        return (self.latency == 0.0 and self.jitter == 0.0
                and self.rate == 0.0 and self.loss == 0.0
                and not self.partitions)

    def to_doc(self) -> dict:
        return {"latency": self.latency, "jitter": self.jitter,
                "rate": self.rate, "burst": self.burst, "loss": self.loss,
                "partitions": [list(w) for w in self.partitions]}

    @staticmethod
    def from_doc(doc: dict) -> "LinkSpec":
        return LinkSpec(
            latency=float(doc.get("latency", 0.0)),
            jitter=float(doc.get("jitter", 0.0)),
            rate=float(doc.get("rate", 0.0)),
            burst=int(doc.get("burst", 64 << 10)),
            loss=float(doc.get("loss", 0.0)),
            partitions=tuple((float(a), float(b))
                             for a, b in doc.get("partitions", ())))


#: A link left unshaped (loopback / colocated nodes).
TRANSPARENT = LinkSpec()


@dataclasses.dataclass
class NetemSpec:
    """Cluster link map. ``links[(src, dst)]`` overrides ``default`` for
    that DIRECTED link (asymmetric up/down links are the point on edge
    deployments); node pairs inside one ``colocated`` group — by default
    the coordinator (-1) and worker 0, which share a process — use a
    transparent local bus unless an explicit override says otherwise."""
    default: LinkSpec = dataclasses.field(default_factory=LinkSpec)
    links: Dict[Tuple[int, int], LinkSpec] = dataclasses.field(
        default_factory=dict)
    seed: int = 0
    colocated: Tuple[Tuple[int, ...], ...] = ((-1, 0),)

    def link(self, src: int, dst: int) -> LinkSpec:
        """The spec governing src -> dst traffic."""
        spec = self.links.get((src, dst))
        if spec is not None:
            return spec
        if src == dst:
            return TRANSPARENT
        for group in self.colocated:
            if src in group and dst in group:
                return TRANSPARENT
        return self.default

    # --------------------------- serialization ---------------------------

    def to_doc(self) -> dict:
        """Plain-JSON form (the ``--netem`` CLI flag's schema; see
        docs/operations.md)."""
        return {"seed": self.seed,
                "default": self.default.to_doc(),
                "colocated": [list(g) for g in self.colocated],
                "links": {f"{s}->{d}": spec.to_doc()
                          for (s, d), spec in sorted(self.links.items())}}

    @staticmethod
    def from_doc(doc: dict) -> "NetemSpec":
        links = {}
        for key, sub in (doc.get("links") or {}).items():
            s, _, d = key.partition("->")
            links[(int(s), int(d))] = LinkSpec.from_doc(sub)
        colocated = tuple(tuple(int(n) for n in g)
                          for g in doc.get("colocated", ((-1, 0),)))
        return NetemSpec(default=LinkSpec.from_doc(doc.get("default", {})),
                         links=links, seed=int(doc.get("seed", 0)),
                         colocated=colocated)

    @staticmethod
    def from_json(text_or_path: str) -> "NetemSpec":
        """Parse the ``--netem`` CLI value: inline JSON (starts with
        ``{``) or a path to a JSON file."""
        import json
        text = text_or_path.strip()
        if not text.startswith("{"):
            with open(text_or_path) as f:
                text = f.read()
        return NetemSpec.from_doc(json.loads(text))

    @staticmethod
    def wan(latency: float = 0.0, jitter: float = 0.0, rate: float = 0.0,
            loss: float = 0.0, seed: int = 0, burst: int = 64 << 10
            ) -> "NetemSpec":
        """Uniform WAN: every inter-node link gets the same shape."""
        return NetemSpec(default=LinkSpec(latency=latency, jitter=jitter,
                                          rate=rate, burst=burst,
                                          loss=loss),
                         seed=seed)


class _Scheduler:
    """One daemon thread delivering delayed messages for a whole
    transport, in due-time order (ties broken by submission order). This
    is what replaces per-message ``threading.Timer`` spawns: N in-flight
    delayed messages cost one thread, not N."""

    def __init__(self, name: str = "netem-sched"):
        self._heap: list = []
        self._cv = threading.Condition()
        self._seq = itertools.count()
        self._thread: Optional[threading.Thread] = None
        self._name = name
        self.closed = False

    def schedule(self, due: float, fn: Callable[[], None]) -> None:
        """Run ``fn()`` on the scheduler thread at monotonic time ``due``
        (immediately if that is already past)."""
        with self._cv:
            if self.closed:
                return
            heapq.heappush(self._heap, (due, next(self._seq), fn))
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name=self._name)
                self._thread.start()
            self._cv.notify()

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self.closed:
                    if not self._heap:
                        self._cv.wait()
                        continue
                    wait = self._heap[0][0] - time.monotonic()
                    if wait <= 0:
                        break
                    self._cv.wait(wait)
                if self.closed:
                    return
                _, _, fn = heapq.heappop(self._heap)
            try:
                fn()
            except Exception:
                pass                   # a receiver died mid-delivery

    def close(self) -> None:
        with self._cv:
            self.closed = True
            self._heap.clear()
            self._cv.notify_all()


class LinkShaper:
    """Per-transport netem runtime: prices every message against its
    link's ``LinkSpec`` and owns the delivery ``_Scheduler``.

    ``admit`` is pure bookkeeping (no sleeping, no threads): it returns
    the delay after which the message arrives, or ``None`` when the link
    drops it (loss dice or a partition window). The caller delivers
    immediately for delay 0 and otherwise hands the delivery closure to
    ``self.scheduler``. ``now`` is injectable for deterministic tests."""

    def __init__(self, spec: NetemSpec, name: str = "netem-sched"):
        self.spec = spec
        self.scheduler = _Scheduler(name=name)
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._rng: Dict[Tuple[int, int], random.Random] = {}
        self._bucket_vt: Dict[Tuple[int, int], float] = {}
        self._last_arrival: Dict[Tuple[int, int], float] = {}
        self.stats = {"shaped": 0, "netem_dropped": 0, "netem_blocked": 0,
                      "delayed": 0}

    def _link_rng(self, key: Tuple[int, int]) -> random.Random:
        rng = self._rng.get(key)
        if rng is None:
            # int-mix of (seed, src, dst): deterministic across runs and
            # processes (unlike tuple seeding, deprecated in 3.9)
            mixed = (self.spec.seed * 1_000_003
                     + (key[0] + 512) * 1009 + (key[1] + 512))
            rng = self._rng[key] = random.Random(mixed)
        return rng

    def admit(self, src: int, dst: int, nbytes: int,
              now: Optional[float] = None) -> Optional[float]:
        """Price one ``nbytes`` message on link src -> dst. Returns the
        delay (seconds from ``now``) until it arrives, or ``None`` when
        the link drops it. Per-link FIFO is guaranteed: a later admit on
        the same link never yields an earlier arrival."""
        link = self.spec.link(src, dst)
        if link.is_transparent():
            return 0.0
        if now is None:
            now = time.monotonic()
        key = (src, dst)
        with self._lock:
            t = now - self._t0
            for a, b in link.partitions:
                if a <= t < b:
                    self.stats["netem_blocked"] += 1
                    return None
            if link.loss > 0.0 and self._link_rng(key).random() < link.loss:
                self.stats["netem_dropped"] += 1
                return None
            depart = now
            if link.rate > 0.0:
                # token bucket as a virtual finish time: vt may lag `now`
                # by at most burst/rate (that lag IS the accumulated
                # credit), and each message advances it by its
                # serialization time
                floor = now - link.burst / link.rate
                vt = max(self._bucket_vt.get(key, floor), floor)
                vt += nbytes / link.rate
                self._bucket_vt[key] = vt
                depart = max(now, vt)
            arrival = depart + link.latency
            if link.jitter > 0.0:
                arrival += self._link_rng(key).uniform(-link.jitter,
                                                       link.jitter)
            # monotone per link: jitter must not reorder a FIFO stream,
            # and arrival can never precede departure
            arrival = max(arrival, depart,
                          self._last_arrival.get(key, 0.0))
            self._last_arrival[key] = arrival
            self.stats["shaped"] += 1
            delay = arrival - now
            if delay > 0.0:
                self.stats["delayed"] += 1
            return delay

    def close(self) -> None:
        self.scheduler.close()
