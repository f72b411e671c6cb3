"""In-process message transport for the live FTPipeHD runtime.

One ``Transport`` connects all nodes of a training cluster: every node
(worker device or the coordinator control plane) registers an inbox, and
``send`` delivers a ``Message`` into the destination's queue. Faults are
injectable so the fault-tolerance protocol can be exercised for real:

  * ``kill(node)``     — the node vanishes: messages to AND from it are
                         silently dropped (a crashed edge device),
  * ``FaultSpec.drop`` — Bernoulli loss per message (flaky WiFi),
  * ``FaultSpec.delay``— fixed delivery latency on every link.

Beyond reachability faults, a ``runtime/netem.py`` ``NetemSpec`` shapes
the links themselves — per-link one-way latency + jitter, token-bucket
bandwidth, probabilistic loss, and timed partitions — under EITHER
transport (this queue one and ``runtime/net.py``'s sockets), so WAN-class
conditions are emulated identically in-process and across processes.
``FaultSpec.delay`` is implemented as the degenerate netem spec (every
link a fixed-latency pipe); all delayed deliveries ride one scheduler
thread, not a timer thread per message. Link *capacity* still enters the
partitioning protocol through the coordinator's bandwidth matrix (what
the paper's central node measures), exactly as in
``runtime/simulator.py`` — netem is the physics those measurements see.

With ``codec=True`` every payload round-trips through the wire format of
``runtime/codec.py`` (encode to ``bytes`` at send, decode at deliver), so
the in-process queue behaves like a socket: receivers get a fresh
deserialized copy (no shared references), anything unserializable fails
loudly at the sender, and ``stats["bytes"]`` counts exact wire bytes
instead of the array-leaf estimate. A ``codec.WirePolicy`` additionally
selects the compression tier per message class (fp16 / int8 quantized
tensors for the data plane and §III-E replica traffic); any compression
implies the codec, and ``stats["data_bytes"]`` / ``stats["replica_bytes"]``
break the wire volume down by class so compression wins are measurable.
``stats["kind_bytes"]`` / ``stats["kind_msgs"]`` refine that further into
act / grad / replica / control counters (``kind_class``), surfaced through
``Run.status()`` so a compression tier's win is attributable per plane.
"""
from __future__ import annotations

import abc
import dataclasses
import queue
import random
import threading
import time
from typing import Any, Dict, Optional, Tuple

from repro_torch.runtime import codec as wire
from repro_torch.runtime import netem as netem_mod


@dataclasses.dataclass(frozen=True)
class Message:
    """One delivered transport message: ``kind`` names the protocol event
    (see ``docs/protocol.md`` for the full catalog), ``payload`` its
    decoded body. Shared by the queue transport and ``runtime/net.py``'s
    TCP transport, so receivers never know which one they are on."""
    src: int
    dst: int
    kind: str
    payload: Any
    sent_at: float


@dataclasses.dataclass
class FaultSpec:
    """Link-level fault injection. ``drop`` applies to data/control traffic
    uniformly; ``protect`` lists message kinds that are never dropped (e.g.
    retransmit-free control commands in tests)."""
    drop: float = 0.0
    delay: float = 0.0
    seed: int = 0
    protect: tuple = ()


def payload_bytes(payload: Any) -> int:
    """Approximate wire size of a message payload (array leaves only)."""
    total = 0
    stack = [payload]
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif hasattr(x, "nbytes"):
            total += int(x.nbytes)
        elif isinstance(x, (int, float, bool)):
            total += 8
    return total


#: Message-kind classes used by the per-kind stats breakdown. ``act`` and
#: ``grad`` are singled out (they are the two data-plane directions whose
#: compression tier differs per run); everything in ``codec.REPLICA_KINDS``
#: is ``replica`` — except the overlap scheduler's deferred shipments
#: (``ov_chain_put``/``ov_global_put``), attributed to ``replica_ov`` so
#: stats show which replica bytes rode a segment instead of a drain; the
#: rest of the protocol catalog is ``control``.
KIND_CLASSES = ("act", "grad", "replica", "replica_ov", "control")


def kind_class(kind: str) -> str:
    """Map a protocol message kind to its stats class."""
    if kind in ("act", "grad"):
        return kind
    if kind in wire.REPLICA_KINDS:
        return "replica_ov" if kind.startswith("ov_") else "replica"
    return "control"


def _kind_class_counters() -> Dict[str, int]:
    return {c: 0 for c in KIND_CLASSES}


class TransportBase(abc.ABC):
    """Abstract surface every FTPipeHD transport implements.

    Two concrete transports exist — the in-process queue ``Transport``
    below and ``runtime/net.py``'s ``SocketTransport`` over TCP — and
    all runtime code (``runtime/live.py``, the facade in ``repro/run.py``)
    is written against this ABC, so a cluster runs unchanged on either.
    Construct via ``Transport.create(kind, ...)`` rather than the
    concrete constructors; the factory keeps call sites transport-agnostic
    and is the only place that needs to know socket-specific arguments.

    The base class also hosts the shared **seq/ack retransmit window**
    for the data plane (``codec.RELIABLE_KINDS``, docs/protocol.md §7):
    with ``reliable=True`` a sender wraps each ``act``/``grad`` payload as
    ``{"_seq": n, "body": ...}`` and keeps it in a window until the
    receiver's ``ack`` arrives; a retransmit daemon resends unacked frames
    every ``rto`` seconds so a dropped frame costs a resend instead of a
    segment-timeout drain. Receivers deduplicate by per-(src, dst)
    sequence floor + out-of-order buffer and acknowledge CUMULATIVELY:
    the daemon flushes at most one small ack frame per peer per ``rto/4``
    tick carrying ``{era, floor, seqs}`` — everything below ``floor``
    plus the listed out-of-order seqs is retired at the sender. Batching
    acks off the receive path costs ~rto/4 of ack latency (far under the
    retransmit timeout) and keeps the window's lossless-link overhead
    low (gated in ``benchmarks/bench_live_throughput.py``). Acks are
    consumed at the transport layer — worker code never sees them. Reliability is a cluster-wide setting:
    enable it on every node's transport or none (a reliable receiver
    passes plain-sender frames through untouched, but a plain receiver
    would surface the wrapped dict to worker code)."""

    #: True for transports that move bytes between processes (sockets);
    #: the coordinator uses this to decide whether an admitted worker
    #: needs routes learned / an external respawner.
    is_networked: bool = False

    # ------------------------- abstract surface -------------------------

    @abc.abstractmethod
    def register(self, node: int) -> None: ...

    @abc.abstractmethod
    def send(self, src: int, dst: int, kind: str, payload: Any = None,
             *, _retx: bool = False) -> bool: ...

    @abc.abstractmethod
    def recv(self, node: int, timeout: float = 0.05) -> Optional[Message]: ...

    @abc.abstractmethod
    def kill(self, node: int) -> None: ...

    @abc.abstractmethod
    def revive(self, node: int) -> None: ...

    @abc.abstractmethod
    def is_alive(self, node: int) -> bool: ...

    @abc.abstractmethod
    def set_policy(self, policy: wire.WirePolicy) -> None: ...

    # --------------------- concrete shared defaults ---------------------

    def add_route(self, node: int, addr: Tuple[str, int]) -> None:
        """Learn a peer's address (no-op for in-process transports)."""

    def addresses(self) -> Dict[int, Tuple[str, int]]:
        """node -> (host, port) routing table; empty when in-process."""
        return {}

    def close(self) -> None:
        """Release sockets/threads; idempotent. Queue transports only
        need the flag (it stops the retransmit daemon) plus the netem
        scheduler shutdown."""
        self.closed = True
        self._netem_close()

    @staticmethod
    def create(kind: str, *, fault: Optional[FaultSpec] = None,
               codec: bool = False,
               policy: Optional[wire.WirePolicy] = None,
               reliable: bool = False, rto: float = 0.25,
               netem: Optional[netem_mod.NetemSpec] = None,
               addr_of: Optional[Dict[int, Tuple[str, int]]] = None,
               local: Optional[Tuple[int, int]] = None,
               **kw: Any) -> "TransportBase":
        """Factory for call sites that should not care which concrete
        transport they get: ``kind`` is ``"queue"`` (in-process threads)
        or ``"tcp"`` (``SocketTransport``; needs ``addr_of`` + ``local``,
        extra kwargs like ``retry_window`` pass through)."""
        if kind == "queue":
            return Transport(fault, codec=codec, policy=policy,
                             reliable=reliable, rto=rto, netem=netem, **kw)
        if kind == "tcp":
            from repro_torch.runtime.net import SocketTransport
            if addr_of is None or local is None:
                raise ValueError("tcp transport needs addr_of and local")
            return SocketTransport(addr_of, local, fault, policy=policy,
                                   reliable=reliable, rto=rto, netem=netem,
                                   **kw)
        raise ValueError(f"unknown transport kind {kind!r} "
                         f"(expected 'queue' or 'tcp')")

    # ------------------------ shared netem shaping -----------------------

    def _netem_init(self, netem: Optional[netem_mod.NetemSpec],
                    fault: FaultSpec) -> None:
        """Build the link shaper (call once from a concrete __init__
        AFTER ``self.stats`` exists). An explicit ``NetemSpec`` wins;
        without one, a legacy ``FaultSpec.delay`` becomes the degenerate
        spec shaping every link into a fixed-latency pipe — same
        semantics as the old per-message timer threads, minus the
        unbounded thread spawn."""
        spec = netem
        if spec is None and fault.delay > 0.0:
            spec = netem_mod.NetemSpec(
                default=netem_mod.LinkSpec(latency=fault.delay),
                seed=fault.seed, colocated=())
        self.netem = netem_mod.LinkShaper(spec) if spec is not None else None
        self.stats.setdefault("netem_dropped", 0)

    def _netem_admit(self, src: int, dst: int,
                     nbytes: int) -> Optional[float]:
        """Price one message; ``None`` = the link dropped it (accounted),
        else the delivery delay in seconds (0.0 = deliver inline)."""
        verdict = self.netem.admit(src, dst, nbytes)
        if verdict is None:
            with self._lock:
                self.stats["netem_dropped"] += 1
        return verdict

    def _netem_close(self) -> None:
        shaper = getattr(self, "netem", None)
        if shaper is not None:
            shaper.close()

    def stats_snapshot(self) -> dict:
        """``self.stats`` plus the link shaper's counters (``shaped``,
        ``netem_blocked``, per-link breakdowns) when a NetemSpec is
        active — the view result reports carry."""
        snap = dict(self.stats)
        if getattr(self, "netem", None) is not None:
            snap.update(self.netem.stats)
        return snap

    # -------------------- shared reliable-data layer --------------------

    def _rel_init(self, reliable: bool, rto: float,
                  expiry: float = 10.0) -> None:
        """Call once from a concrete __init__ AFTER ``self.stats`` exists.
        ``expiry`` bounds how long an unacked frame is retried (the socket
        transport passes its per-frame retry_window)."""
        self.closed = False
        self._rel_on = bool(reliable)
        self._rel_rto = float(rto)
        self._rel_expiry = float(expiry)
        self._rel_lock = threading.Lock()
        self._rel_era = 0
        self._rel_next: Dict[Tuple[int, int], int] = {}
        self._rel_window: Dict[Tuple[int, int, int], dict] = {}
        self._rel_seen: Dict[Tuple[int, int], list] = {}
        self._rel_ack_due: set = set()       # (src, dst) owing an ack flush
        self._rel_thread: Optional[threading.Thread] = None
        for k in ("retransmits", "rel_dups", "rel_expired", "rel_stale"):
            self.stats.setdefault(k, 0)

    def _rel_wrap(self, src: int, dst: int, kind: str, payload: Any) -> Any:
        """Assign the next (src, dst) sequence number, park the wrapped
        frame in the retransmit window, and return the wrapped payload."""
        with self._rel_lock:
            seq = self._rel_next.get((src, dst), 0)
            self._rel_next[(src, dst)] = seq + 1
            wrapped = {"_seq": seq, "_era": self._rel_era, "body": payload}
            now = time.monotonic()
            self._rel_window[(src, dst, seq)] = {
                "kind": kind, "payload": wrapped, "born": now, "last": now}
            self._rel_ensure_loop_locked()
        return wrapped

    def _rel_ensure_loop_locked(self) -> None:
        """Start the retransmit/ack-flush daemon (call under _rel_lock)."""
        if self._rel_thread is None:
            t = threading.Thread(target=self._rel_loop, daemon=True,
                                 name="rel-retx")
            self._rel_thread = t
            t.start()

    def _rel_deliver(self, src: int, dst: int, kind: str, payload: Any):
        """Receive-side hook. Returns ``None`` when the frame is not the
        reliable layer's business (enqueue it unchanged), else a pair
        ``(fresh, released)``: ``fresh`` is False for acks and duplicate
        retransmits (account nothing), and ``released`` is the in-order
        list of ``(kind, body)`` frames now deliverable — out-of-order
        arrivals are buffered until the (src, dst) sequence floor reaches
        them, so receivers see the data plane as an ordered stream even
        when a retransmitted frame overtakes its successors."""
        if kind == wire.ACK_KIND:
            if not isinstance(payload, dict):
                return (False, [])
            era = int(payload.get("era", 0))
            floor = int(payload.get("floor", 0))
            seqs = set(payload.get("seqs", ()))
            with self._rel_lock:
                # an ack from a PREVIOUS era must not retire a current-era
                # frame that happens to share its sequence number
                if era == self._rel_era:
                    # cumulative: everything below the receiver's in-order
                    # floor, plus its buffered out-of-order arrivals
                    for key in [k for k in self._rel_window
                                if k[0] == dst and k[1] == src
                                and (k[2] < floor or k[2] in seqs)]:
                        del self._rel_window[key]
            return (False, [])
        if (kind in wire.RELIABLE_KINDS and isinstance(payload, dict)
                and "_seq" in payload):
            seq = int(payload["_seq"])
            era = int(payload.get("_era", 0))
            with self._rel_lock:
                ent = self._rel_seen.setdefault((src, dst), [era, 0, {}])
                if era < ent[0]:
                    # a straggler from before the sender's last reset
                    # (coordinator re-adoption fences a new era): stale
                    # content that must not occupy a current-era slot
                    self.stats["rel_stale"] += 1
                    return (False, [])
                if era > ent[0]:
                    ent[:] = [era, 0, {}]      # sender reset: fresh stream
                buf = ent[2]
                if seq < ent[1] or seq in buf:
                    # the ack for the first copy may have been lost: owe
                    # the sender a (cumulative) re-ack at the next flush
                    self._rel_ack_due.add((src, dst))
                    self._rel_ensure_loop_locked()
                    self.stats["rel_dups"] += 1
                    return (False, [])
                buf[seq] = (kind, payload.get("body"))
                released = []
                while ent[1] in buf:          # advance the contiguous floor
                    released.append(buf.pop(ent[1]))
                    ent[1] += 1
                self._rel_ack_due.add((src, dst))
                self._rel_ensure_loop_locked()
            return (True, released)
        return None

    def _rel_forget(self, node: int) -> None:
        """Drop window state touching ``node`` (it was fenced/killed)."""
        with self._rel_lock:
            for key in [k for k in self._rel_window if node in k[:2]]:
                del self._rel_window[key]

    def reliable_reset(self) -> None:
        """Drop ALL reliable-delivery state: send sequences, retransmit
        window, receive floors — and advance this node's ERA, stamped
        into every subsequent frame. Called when an ``install`` resets
        the pipeline state around this node (startup, coordinator
        re-adoption — docs/protocol.md §8): a relaunched peer restarts
        its sequence space at 0, so floors inherited from the previous
        incarnation would swallow its frames as duplicates, while this
        node's own pre-reset stragglers (already queued to the OS, or a
        peer's last retransmits) must not collide with fresh sequence
        numbers — the era tag lets receivers drop them instead."""
        if not self._rel_on:
            return
        with self._rel_lock:
            self._rel_era += 1
            self._rel_next.clear()
            self._rel_window.clear()
            self._rel_seen.clear()
            self._rel_ack_due.clear()

    def _rel_loop(self) -> None:
        while not self.closed:
            time.sleep(max(0.01, self._rel_rto / 4.0))
            now = time.monotonic()
            resend = []
            acks = []
            with self._rel_lock:
                for key, ent in list(self._rel_window.items()):
                    if now - ent["born"] > self._rel_expiry:
                        del self._rel_window[key]
                        self.stats["rel_expired"] += 1
                        continue
                    if now - ent["last"] > self._rel_rto:
                        ent["last"] = now
                        resend.append((key, ent["kind"], ent["payload"]))
                # flush owed acks, one CUMULATIVE frame per (sender,
                # receiver) pair per tick — batching them here instead of
                # acking every data frame inline keeps the ack cost off
                # the receive path (and off the wire: ~1 small frame per
                # rto/4 instead of one per act/grad)
                for src, dst in self._rel_ack_due:
                    ent = self._rel_seen.get((src, dst))
                    if ent is not None:
                        acks.append((dst, src, {"era": ent[0],
                                                "floor": ent[1],
                                                "seqs": list(ent[2])}))
                self._rel_ack_due.clear()
            for (src, dst, _seq), kind, payload in resend:
                self.send(src, dst, kind, payload, _retx=True)
            for src, dst, payload in acks:
                self.send(src, dst, wire.ACK_KIND, payload)


class Transport(TransportBase):
    """In-process (thread-to-thread) transport: per-node inboxes over
    ``queue.Queue`` with injectable faults. ``runtime/net.py``'s
    ``SocketTransport`` implements this same ``TransportBase`` surface
    (``register`` / ``send`` / ``recv`` / ``kill`` / ``revive`` /
    ``is_alive`` / ``stats``) over TCP — code written against either
    runs on both. Prefer ``Transport.create("queue", ...)`` over calling
    this constructor directly."""

    def __init__(self, fault: Optional[FaultSpec] = None,
                 codec: bool = False,
                 policy: Optional[wire.WirePolicy] = None,
                 reliable: bool = False, rto: float = 0.25,
                 netem: Optional[netem_mod.NetemSpec] = None):
        self.fault = fault or FaultSpec()
        self.policy = policy or wire.WirePolicy()
        # compression is a property of the byte encoding, so any
        # compressing policy forces the codec on
        self.codec = codec or self.policy.any_compression()
        self._rng = random.Random(self.fault.seed)
        self._inboxes: dict[int, queue.Queue] = {}
        self._dead: set[int] = set()
        self._lock = threading.Lock()
        self.stats = {"sent": 0, "delivered": 0, "dropped": 0,
                      "to_dead": 0, "bytes": 0, "data_bytes": 0,
                      "replica_bytes": 0,
                      "kind_bytes": _kind_class_counters(),
                      "kind_msgs": _kind_class_counters()}
        self._rel_init(reliable, rto)
        self._netem_init(netem, self.fault)

    def set_policy(self, policy: wire.WirePolicy) -> None:
        """Adopt a wire-compression policy at runtime (the coordinator's
        install/admit handshake makes its policy authoritative)."""
        self.policy = policy
        self.codec = self.codec or policy.any_compression()

    # ------------------------------ wiring ------------------------------

    def register(self, node: int) -> None:
        """Create the node's inbox (idempotent); must precede recv."""
        with self._lock:
            self._inboxes.setdefault(node, queue.Queue())

    def kill(self, node: int) -> None:
        """The node crashes: it stops sending and stops receiving."""
        with self._lock:
            self._dead.add(node)
            q = self._inboxes.get(node)
        self._rel_forget(node)             # stop retransmitting to a corpse
        if q is not None:                  # drain pending traffic
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass

    def revive(self, node: int) -> None:
        """Paper case 2: a worker restarts (fresh state, same slot)."""
        with self._lock:
            self._dead.discard(node)

    def is_alive(self, node: int) -> bool:
        with self._lock:
            return node not in self._dead

    # ----------------------------- messaging ----------------------------

    def send(self, src: int, dst: int, kind: str, payload: Any = None,
             *, _retx: bool = False) -> bool:
        """Deliver (or drop, per faults). Returns whether it was delivered;
        senders must NOT rely on this — a real network gives no such signal,
        and the protocol's heartbeats/timeouts are what detect loss. (With
        ``reliable=True`` the transport itself retransmits unacked
        ``act``/``grad`` frames, so even those senders stay fire-and-forget.)

        ``hello`` is the one kind that crosses a kill-fence: it is the
        admission message of a NEW incarnation of a fenced device
        (elastic rejoin), and the coordinator decides by the incarnation
        number in its payload whether to admit or ignore it — fencing it
        at the transport would make rejoin impossible."""
        if self._rel_on and not _retx and kind in wire.RELIABLE_KINDS:
            # wrap before the fault dice: a dropped first copy stays in
            # the window and the retransmit daemon re-rolls it
            payload = self._rel_wrap(src, dst, kind, payload)
        with self._lock:
            self.stats["sent"] += 1
            if _retx:
                self.stats["retransmits"] += 1
            if (src in self._dead or dst in self._dead) and kind != "hello":
                self.stats["to_dead"] += 1
                return False
            if (self.fault.drop > 0.0 and kind not in self.fault.protect
                    and self._rng.random() < self.fault.drop):
                self.stats["dropped"] += 1
                return False
            inbox = self._inboxes.get(dst)
        if inbox is None:
            return False
        if self.codec:
            data = wire.encode(kind, payload,
                               tier=self.policy.tier_for(kind))
            nbytes = len(data)
            kind, payload = wire.decode(data)
        else:
            nbytes = payload_bytes(payload)
        is_data = kind in wire.DATA_KINDS
        is_replica = kind in wire.REPLICA_KINDS
        cls = kind_class(kind)

        def _account():
            with self._lock:
                self.stats["delivered"] += 1
                self.stats["bytes"] += nbytes
                self.stats["kind_bytes"][cls] += nbytes
                self.stats["kind_msgs"][cls] += 1
                if is_data:
                    self.stats["data_bytes"] += nbytes
                elif is_replica:
                    self.stats["replica_bytes"] += nbytes

        def _put():
            if self._rel_on:
                hit = self._rel_deliver(src, dst, kind, payload)
                if hit is not None:        # ack/dup/ordered-release path
                    fresh, released = hit
                    for k2, body in released:
                        inbox.put(Message(src=src, dst=dst, kind=k2,
                                          payload=body,
                                          sent_at=time.monotonic()))
                    if fresh:
                        _account()
                    return
            inbox.put(Message(src=src, dst=dst, kind=kind, payload=payload,
                              sent_at=time.monotonic()))
            _account()

        delay = 0.0
        if self.netem is not None:
            verdict = self._netem_admit(src, dst, nbytes)
            if verdict is None:
                return False               # the shaped link dropped it
            delay = verdict
        if delay > 0.0:
            def _deliver():
                with self._lock:          # re-check: dst may have died (or
                    if dst in self._dead:  # been killed+revived) in flight
                        return
                _put()
            self.netem.scheduler.schedule(time.monotonic() + delay,
                                          _deliver)
        else:
            _put()
        return True

    def recv(self, node: int, timeout: float = 0.05) -> Optional[Message]:
        """Blocking receive with timeout; None on timeout or if dead."""
        with self._lock:
            inbox = self._inboxes.get(node)
            dead = node in self._dead
        if inbox is None or dead:
            time.sleep(min(timeout, 0.01))
            return None
        try:
            return inbox.get(timeout=timeout)
        except queue.Empty:
            return None


class Heartbeat(threading.Thread):
    """Per-worker liveness beacon (paper §III-F runs a timer at the central
    node; workers must be heard from periodically)."""

    def __init__(self, transport: Transport, src: int, dst: int,
                 interval: float):
        super().__init__(daemon=True, name=f"hb-{src}")
        self.transport = transport
        self.src, self.dst = src, dst
        self.interval = interval
        self.stop_event = threading.Event()

    def run(self):
        while not self.stop_event.wait(self.interval):
            self.transport.send(self.src, self.dst, "hb",
                                {"t": time.monotonic()})

    def stop(self):
        self.stop_event.set()
