"""Multi-process TCP transport for the live FTPipeHD runtime.

``runtime/transport.Transport`` moves messages between threads of ONE
process; this module moves the same messages between separate OS processes
(or separate hosts) over TCP, so that "a worker dies" means a SIGKILLed
process and a broken socket, not a drained queue. The wire format is the
tagged binary codec of ``runtime/codec.py`` — every payload crosses the
process boundary as the exact bytes ``Transport(codec=True)`` already
round-trips in-process, which is what makes queue and TCP runs
byte-equivalent at the protocol layer (see ``tests/test_net.py``).

Pieces:

``SocketTransport``
    Drop-in replacement for ``Transport`` (same ``register`` / ``send`` /
    ``recv`` / ``kill`` / ``revive`` / ``is_alive`` / ``stats`` surface)
    backed by length-prefixed TCP frames. One process may host several
    node ids (the coordinator process hosts the control plane ``COORD``
    and worker device 0); each remote peer gets a dedicated sender thread
    with reconnect-with-backoff, and inbound connections get reader
    threads that demultiplex frames into per-node inboxes. Delivery is
    best-effort exactly like the queue transport: a frame that cannot be
    sent within its retry window is dropped, and the protocol's
    heartbeats/timeouts are what detect the loss.

``worker_main`` / ``run_tcp_training``
    The multi-process harness. ``run_tcp_training`` spawns one OS process
    per non-central worker (``multiprocessing`` "spawn" context: each child
    is a fresh interpreter with its own CUDA context — CUDA does not
    survive ``fork``), runs the coordinator + worker 0 in the calling
    process, and returns the usual ``LiveResult``. Each worker process
    rebuilds the identical chain and batch stream from a
    ``runtime/workload.WorkloadSpec`` (both are deterministic in the seed)
    on ``LiveConfig.device``, so only activations, gradients, weights and
    control traffic travel the wire — the same division of labor the paper
    assumes between edge devices. Nothing that crosses into a child is a
    tensor: the spec and the config are plain picklable data.
    ``launch/live_train.py --transport tcp`` drives this harness; with
    ``--role coordinator|worker`` the same entry point runs one process per
    host for real multi-host use.

Numerics settings do not cross ``spawn``: a child starts with torch's
defaults (cuDNN TF32 on, cuDNN autotuning off, its own thread count). So
``run_tcp_training`` captures the caller's settings
(``numerics_settings``) and every process it starts applies them
(``apply_numerics``) before it builds the chain — a TCP run computes as
the same config's queue run does, where every worker shares the caller's
settings.

Fault injection is real here: the coordinator's ``kill`` schedule sends a
``die`` control message and the worker process SIGKILLs itself — no
goodbye, sockets break mid-stream, heartbeats stop — and §III-F recovery
proceeds from observed silence, exactly as on a crashed edge device.

Frame layout (little-endian)::

    u32 length | i32 src | i32 dst | codec.encode(kind, payload)

``length`` counts everything after itself. Node ids are signed because the
coordinator control plane is node ``-1`` (``live.COORD``).
"""
from __future__ import annotations

import queue
import select
import socket
import struct
import threading
import time
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

from repro_torch.runtime import codec as wire
from repro_torch.runtime.transport import (FaultSpec, Message,
                                           TransportBase,
                                           _kind_class_counters,
                                           kind_class)

_HDR = struct.Struct("<Iii")          # length | src | dst (length excludes u32)
_MAX_FRAME = 1 << 31                  # sanity bound on inbound frame length

Addr = Tuple[str, int]


def _ephemeral_floor() -> int:
    """Lowest port of the kernel's ephemeral range (Linux), else 0."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0


def _probe(host: str, port: int) -> Optional[socket.socket]:
    """A socket bound to ``(host, port)``, or None when it is taken."""
    s = socket.socket()
    try:
        s.bind((host, port))
        return s
    except OSError:
        s.close()
        return None


def free_ports(host: str, count: int) -> list:
    """``count`` distinct ports that are free now. They are drawn below
    the kernel's ephemeral range where it has room, so that no outgoing
    connection's automatic local port can take one between this probe and
    the moment a worker process binds it (seconds later, after its
    interpreter starts); else the OS picks them. Every probe socket stays
    bound until all are chosen, so the ports are distinct."""
    import random
    floor = _ephemeral_floor()
    held: list = []
    try:
        tries = 0
        while len(held) < count and floor > 12_000 and tries < 200:
            tries += 1
            s = _probe(host, random.randrange(10_000, floor))
            if s is not None:
                held.append(s)
        while len(held) < count:
            held.append(_probe(host, 0))
        return [s.getsockname()[1] for s in held]
    finally:
        for s in held:
            s.close()


def free_port(host: str = "127.0.0.1") -> int:
    """A currently-free TCP port (another process may still take it before
    it is bound; see ``free_ports`` for why that is unlikely)."""
    return free_ports(host, 1)[0]


def parse_peers(spec: str) -> Dict[int, Addr]:
    """Parse ``--peers`` strings: ``coord=HOST:PORT,1=HOST:PORT,...``.

    ``coord`` expands to BOTH node ids hosted by the coordinator process
    (the control plane ``COORD`` = -1 and worker device 0); integer keys
    name worker devices. Returns {node id -> (host, port)}."""
    out: Dict[int, Addr] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        key, _, addr = part.partition("=")
        host, _, port = addr.rpartition(":")
        if not host or not port:
            raise ValueError(f"--peers entry {part!r} is not KEY=HOST:PORT")
        a = (host, int(port))
        if key.strip() == "coord":
            out[-1] = a
            out[0] = a
        else:
            out[int(key)] = a
    return out


class _Peer:
    """Outbound connection to one remote address: a frame queue drained by
    a sender thread that dials with exponential backoff and retries each
    frame until its per-frame window expires (then drops it — the network
    gives no delivery guarantee and the protocol must not assume one).

    The sender COALESCES: after blocking on the first frame it drains
    whatever else is already queued (up to ``coalesce_bytes``) and ships
    the batch as one ``sendall``. Small control frames (acts, grads,
    heartbeats) otherwise cost one syscall each, which is what capped the
    TCP transport at a fraction of the in-process throughput; with
    TCP_NODELAY set (no Nagle delay on the last partial segment) batching
    in userspace is both lower latency AND higher throughput. On a send
    failure the whole batch is retried on a fresh connection — duplicates
    are possible (exactly as with per-frame retries) and every protocol
    message is idempotent by design."""

    def __init__(self, addr: Addr, transport: "SocketTransport"):
        self.addr = addr
        self.transport = transport
        self.q: "queue.Queue[Optional[tuple]]" = queue.Queue()
        self.sock: Optional[socket.socket] = None
        self.thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"net-send-{addr[0]}:{addr[1]}")
        self.thread.start()

    def enqueue(self, frame: bytes) -> None:
        self.q.put((time.monotonic(), frame))

    def close(self) -> None:
        self.q.put(None)

    def _connect(self) -> socket.socket:
        s = socket.create_connection(self.addr, timeout=2.0)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.settimeout(None)
        return s

    def _stale(self) -> bool:
        """Per-incarnation reconnect guard: connections are write-only by
        construction (each process dials its own outbound links), so this
        socket turning READABLE can only mean peer EOF/RST — the process
        behind it died (and may have been relaunched on the same port).
        Detected BEFORE writing, because the first write into a half-open
        socket "succeeds" into the void: without this check a frame to a
        rejoined worker would be silently swallowed by the corpse's
        CLOSE_WAIT socket instead of reaching the new incarnation."""
        if self.sock is None:
            return False
        try:
            readable, _, _ = select.select([self.sock], [], [], 0)
            return bool(readable)
        except (OSError, ValueError):
            return True

    def _next_batch(self) -> Optional[list]:
        """Block for one frame, then coalesce already-queued ones. Returns
        the list of (born, frame) items, or None on shutdown sentinel."""
        item = self.q.get()
        if item is None:
            return None
        batch = [item]
        limit = self.transport.coalesce_bytes
        size = len(item[1])
        while size < limit:
            try:
                nxt = self.q.get_nowait()
            except queue.Empty:
                break
            if nxt is None:              # keep the sentinel for the caller
                self.q.put(None)
                break
            batch.append(nxt)
            size += len(nxt[1])
        return batch

    def _run(self):
        t = self.transport
        backoff = t.backoff_initial
        while not t.closed:
            batch = self._next_batch()
            if batch is None:
                break
            blob = b"".join(frame for _, frame in batch)
            while not t.closed:
                try:
                    if self._stale():
                        try:
                            self.sock.close()
                        except OSError:
                            pass
                        self.sock = None
                    if self.sock is None:
                        self.sock = self._connect()
                        backoff = t.backoff_initial
                    self.sock.sendall(blob)
                    with t._lock:
                        t.stats["tx_bytes"] += len(blob)
                    break
                except OSError:
                    if self.sock is not None:
                        try:
                            self.sock.close()
                        except OSError:
                            pass
                        self.sock = None
                    # expiry is PER FRAME, as before coalescing: shed only
                    # the frames whose own retry window lapsed, keep
                    # retrying the rest (a fresh control frame must not
                    # inherit a stale queue-mate's deadline)
                    now = time.monotonic()
                    alive = [it for it in batch
                             if now <= it[0] + t.retry_window]
                    if len(alive) != len(batch):
                        with t._lock:
                            t.stats["net_dropped"] += \
                                len(batch) - len(alive)
                        batch = alive
                        if not batch:
                            break             # every frame expired
                        blob = b"".join(frame for _, frame in batch)
                    time.sleep(backoff)
                    backoff = min(backoff * 2, t.backoff_max)
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass


class SocketTransport(TransportBase):
    """``Transport`` over length-prefixed TCP frames (see module docstring).

    Parameters
    ----------
    addr_of : {node id -> (host, port)} for EVERY node in the cluster;
        node ids hosted by the same process share one address.
    local : the node ids hosted by THIS process. The transport binds and
        listens on ``addr_of[local[0]]``.
    fault : optional ``FaultSpec`` — Bernoulli ``drop`` and fixed ``delay``
        are applied on the send path exactly as in the queue transport
        (useful for tests; REAL faults here are dead processes).
    retry_window : seconds a frame may sit in a peer's outbound queue
        while the sender dials/redials before it is dropped.
    coalesce_bytes : sender-side batching bound — a sender thread drains
        up to this many queued bytes into one ``sendall`` (0 disables
        coalescing; used by the throughput benchmark to record the
        before/after of the optimization).
    policy : optional ``codec.WirePolicy`` selecting the compression tier
        per message class (data plane / §III-E replica traffic). Applies
        to the ENCODE side only — decoding is self-describing, so peers
        with different policies interoperate; the coordinator's policy is
        shipped in the install/admit handshake (``set_policy``).
    reliable / rto : enable the shared seq/ack retransmit window of
        ``TransportBase`` on the data plane (``codec.RELIABLE_KINDS``):
        unacked ``act``/``grad`` frames are resent every ``rto`` seconds
        until acked or until ``retry_window`` lapses. Cluster-wide
        setting — every node's transport must agree.
    netem : optional ``netem.NetemSpec`` shaping every link on the SEND
        side (one-way latency + jitter, token-bucket bandwidth, loss,
        timed partitions) — the same shaper the queue transport layers
        in, so WAN emulation behaves identically across transports.
        Each process shapes its own outbound links; give every process
        the same spec (it rides ``LiveConfig``) for a symmetric WAN.
    """

    is_networked = True

    def __init__(self, addr_of: Dict[int, Addr], local: Sequence[int],
                 fault: Optional[FaultSpec] = None, *,
                 retry_window: float = 10.0,
                 backoff: Tuple[float, float] = (0.05, 1.0),
                 coalesce_bytes: int = 1 << 20,
                 policy: Optional[wire.WirePolicy] = None,
                 reliable: bool = False, rto: float = 0.25,
                 netem=None):
        import random
        self.addr_of = dict(addr_of)
        self.local = tuple(local)
        self.fault = fault or FaultSpec()
        self.policy = policy or wire.WirePolicy()
        self._rng = random.Random(self.fault.seed)
        self.retry_window = retry_window
        self.coalesce_bytes = coalesce_bytes
        self.backoff_initial, self.backoff_max = backoff
        self.closed = False
        self._lock = threading.Lock()
        self._inboxes: Dict[int, queue.Queue] = {n: queue.Queue()
                                                 for n in self.local}
        self._dead: set = set()
        self._peers: Dict[Addr, _Peer] = {}
        self._readers: list = []
        self.stats = {"sent": 0, "delivered": 0, "dropped": 0, "to_dead": 0,
                      "bytes": 0, "tx_bytes": 0, "net_dropped": 0,
                      "data_bytes": 0, "replica_bytes": 0,
                      "kind_bytes": _kind_class_counters(),
                      "kind_msgs": _kind_class_counters()}
        # frames past the per-frame retry window are shed by the sender
        # anyway, so bound retransmission attempts by the same horizon
        self._rel_init(reliable, rto, expiry=retry_window)
        self._netem_init(netem, self.fault)
        host, port = self.addr_of[self.local[0]]
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(32)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name=f"net-accept-{port}")
        self._accept_thread.start()

    # ------------------------------ wiring ------------------------------

    def register(self, node: int) -> None:
        """Interface parity with ``Transport.register``: local nodes get an
        inbox at construction; registering a remote node is a no-op (its
        inbox lives in its own process)."""
        if node in self.local:
            self._inboxes.setdefault(node, queue.Queue())

    def set_policy(self, policy: wire.WirePolicy) -> None:
        """Adopt a wire-compression policy at runtime — how a worker
        process converges on the coordinator's policy when the
        ``install``/``admit`` handshake carries one."""
        self.policy = policy

    def add_route(self, node: int, addr: Addr) -> None:
        """Learn (or update) a remote node's address at runtime — how a
        hot-joined device becomes reachable: its ``hello`` carries the
        address it listens on, and the coordinator installs the route
        before admitting it. Safe while senders are running (routes are
        resolved per ``send``)."""
        with self._lock:
            self.addr_of[node] = tuple(addr)

    def addresses(self) -> Dict[int, Addr]:
        """Snapshot of the routing table {node -> (host, port)} — what the
        run manifest persists so a relaunched coordinator can dial the
        surviving workers."""
        with self._lock:
            return dict(self.addr_of)

    def kill(self, node: int) -> None:
        """Fence a node locally: frames to and from it are dropped from now
        on. For a remote node this models the coordinator's *belief* that
        the device is gone (late frames from a zombie are ignored); the
        process itself dies by SIGKILL, not by this call."""
        with self._lock:
            self._dead.add(node)
        self._rel_forget(node)
        q = self._inboxes.get(node)
        if q is not None:
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass

    def revive(self, node: int) -> None:
        """Un-fence a node (paper case 2: a worker restarts, same slot)."""
        with self._lock:
            self._dead.discard(node)

    def is_alive(self, node: int) -> bool:
        with self._lock:
            return node not in self._dead

    # ----------------------------- messaging ----------------------------

    def send(self, src: int, dst: int, kind: str, payload: Any = None,
             *, _retx: bool = False) -> bool:
        """Encode and ship one message. Local destinations loop back through
        the codec (fresh deserialized copy, same as one TCP hop); remote
        destinations are framed and enqueued on the peer's sender thread.
        The return value only means "accepted for delivery" — like a real
        socket write, it is NOT an acknowledgment. ``hello`` crosses a
        kill-fence (see ``Transport.send``): it announces a NEW incarnation
        of a fenced device, and admission is decided by the incarnation in
        its payload, not by the transport."""
        if self._rel_on and not _retx and kind in wire.RELIABLE_KINDS:
            # wrap before the fault dice / enqueue: a lost first copy stays
            # in the retransmit window until the receiver's ack arrives
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
        # encode copies a tensor payload to the host: from here on only
        # bytes are queued, so no sender thread holds a device tensor (the
        # reliable window alone keeps the payload, for retransmission: a
        # stage output is a fresh tensor that nothing writes in place)
        data = wire.encode(kind, payload, tier=self.policy.tier_for(kind))

        def _ship():
            if dst in self._inboxes:
                self._deliver(src, dst, data)
            else:
                addr = self._route(dst)
                if addr is None:
                    return
                frame = _HDR.pack(len(data) + 8, src, dst) + data
                self._peer(addr).enqueue(frame)

        delay = 0.0
        if self.netem is not None:
            # price the actual frame bytes (header included) so the
            # token bucket sees what the wire would
            verdict = self._netem_admit(src, dst, len(data) + 12)
            if verdict is None:
                return False               # the shaped link dropped it
            delay = verdict
        if delay > 0.0:
            self.netem.scheduler.schedule(time.monotonic() + delay, _ship)
        else:
            _ship()
        return True

    def _route(self, dst: int) -> Optional[Addr]:
        with self._lock:
            return self.addr_of.get(dst)

    def recv(self, node: int, timeout: float = 0.05) -> Optional[Message]:
        """Blocking receive with timeout; None on timeout or if fenced."""
        with self._lock:
            dead = node in self._dead
        inbox = self._inboxes.get(node)
        if inbox is None or dead:
            time.sleep(min(timeout, 0.01))
            return None
        try:
            return inbox.get(timeout=timeout)
        except queue.Empty:
            return None

    # ----------------------------- internals ----------------------------

    def _peer(self, addr: Addr) -> _Peer:
        with self._lock:
            p = self._peers.get(addr)
            if p is None:
                p = self._peers[addr] = _Peer(addr, self)
            return p

    def _deliver(self, src: int, dst: int, data: bytes) -> None:
        inbox = self._inboxes.get(dst)
        if inbox is None:
            return
        kind, payload = wire.decode(data)
        with self._lock:
            if (src in self._dead or dst in self._dead) and kind != "hello":
                self.stats["to_dead"] += 1
                return

        cls = kind_class(kind)

        def _account():
            with self._lock:
                self.stats["delivered"] += 1
                self.stats["bytes"] += len(data)
                self.stats["kind_bytes"][cls] += len(data)
                self.stats["kind_msgs"][cls] += 1
                if kind in wire.DATA_KINDS:
                    self.stats["data_bytes"] += len(data)
                elif kind in wire.REPLICA_KINDS:
                    self.stats["replica_bytes"] += len(data)

        if self._rel_on:
            hit = self._rel_deliver(src, dst, kind, payload)
            if hit is not None:            # ack/dup/ordered-release path
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

    def _accept_loop(self):
        while not self.closed:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._read_loop, args=(conn,),
                                 daemon=True, name="net-read")
            # recorded BEFORE its reader starts, under the lock close()
            # reads the list with: a connection that has delivered a frame
            # is one close() shuts down. Recorded after, it could miss
            # close(), stay open, and swallow the peer's next frame (its
            # sender sees no EOF, so no reason to redial a relaunch)
            with self._lock:
                if self.closed:
                    conn.close()
                    return
                self._readers.append((t, conn))
            t.start()

    def _read_loop(self, conn: socket.socket):
        """Reader for one inbound connection: buffered recv (the sender
        coalesces frames, so one recv often yields several) with complete
        frames parsed out of the accumulation buffer."""
        buf = bytearray()
        try:
            while not self.closed:
                while len(buf) >= 4:
                    (length,) = struct.unpack_from("<I", buf, 0)
                    if not 8 <= length < _MAX_FRAME:
                        return                    # framing corruption: drop
                    if len(buf) < 4 + length:
                        break
                    src, dst = struct.unpack_from("<ii", buf, 4)
                    self._deliver(src, dst, bytes(buf[12:4 + length]))
                    del buf[:4 + length]
                chunk = conn.recv(1 << 18)
                if not chunk:
                    return
                buf += chunk
        except OSError:
            return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        """Tear down the listener, accepted connections, and all sender
        threads. Safe to call more than once; in-flight frames may be lost
        (like pulling the cable). Closing accepted connections matters for
        elasticity: it frees the listen port AND sends peers the EOF their
        per-incarnation reconnect check keys on — the same signals a
        SIGKILLed process's kernel would emit."""
        with self._lock:
            self.closed = True
            readers = list(self._readers)
        try:
            # shutdown BEFORE close: close() alone does not wake a thread
            # blocked in accept(), and the in-flight syscall would keep
            # the listening socket alive — blocking a relaunch (same
            # process) from rebinding this port
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        for _, conn in readers:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        with self._lock:
            peers = list(self._peers.values())
        for p in peers:
            p.close()
        self._netem_close()


# ======================= multi-process harness ===========================

def numerics_settings() -> Dict[str, Any]:
    """The calling process's torch numerics settings — what a spawned
    child must apply to compute as this process does."""
    import torch
    return {"cudnn_deterministic": torch.backends.cudnn.deterministic,
            "cudnn_benchmark": torch.backends.cudnn.benchmark,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "num_threads": torch.get_num_threads()}


def apply_numerics(settings: Optional[Dict[str, Any]]) -> None:
    """Apply ``numerics_settings()`` of another process (None: keep this
    process's own)."""
    if not settings:
        return
    import torch
    torch.backends.cudnn.deterministic = settings["cudnn_deterministic"]
    torch.backends.cudnn.benchmark = settings["cudnn_benchmark"]
    torch.backends.cudnn.allow_tf32 = settings["cudnn_allow_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = settings["matmul_allow_tf32"]
    torch.set_num_threads(settings["num_threads"])


def worker_main(dev: int, addr_of: Dict[int, Addr], spec, cfg,
                incarnation: int = 0,
                numerics: Optional[Dict[str, Any]] = None) -> None:
    """Entry point of one worker PROCESS (spawned by ``run_tcp_training``
    or run per-host via ``launch/live_train.py --role worker``).

    Rebuilds the chain/batches from the deterministic ``WorkloadSpec``,
    connects a ``SocketTransport`` for its single node id, announces itself
    to the coordinator, and runs the standard ``live.Worker`` loop until a
    ``stop`` (clean end) or ``die`` (self-SIGKILL fault injection).

    ``incarnation`` > 0 marks a RELAUNCH (elastic rejoin, or a hot-joined
    device never in the startup set): the ``hello`` carries the incarnation
    and this process's listen address, the coordinator admits it at the
    next control point (see ``live.Coordinator``), and a ``die`` addressed
    to an older incarnation is ignored instead of SIGKILLing the fresh
    process.

    ``numerics``: the spawning process's ``numerics_settings()``, applied
    before the chain is built. The chain lives on ``cfg.device``, and the
    first CUDA use (kernel libraries, cuDNN set-up) happens here, before
    the ``hello``, as the coordinator does it for its own worker."""
    from repro_torch.runtime.devices import DeviceSpec
    from repro_torch.runtime.live import Worker
    from repro_torch.runtime.stage_executor import warm_up

    apply_numerics(numerics)
    chain, batches = spec.build(device=cfg.device)
    warm_up(chain, batches[0])
    data_fn = lambda gb: batches[gb % len(batches)]
    specs = (cfg.device_specs
             or [DeviceSpec(f"dev-{i}") for i in range(cfg.num_workers)])
    my_spec = (specs[dev] if dev < len(specs)
               else DeviceSpec(f"dev-{dev}"))          # hot-joined device
    # wire-compression tiers from the shared config; the coordinator's
    # install/admit handshake overrides them if the configs disagree
    transport = SocketTransport(addr_of, local=(dev,), fault=cfg.fault,
                                policy=cfg.wire_policy(),
                                reliable=cfg.reliable_data, rto=cfg.rto,
                                netem=cfg.netem)
    host, port = addr_of[dev]
    # announce=True: the Worker loop sends the hello AND re-sends it until
    # the coordinator is heard from — one lost hello (drop fault, expired
    # retry window) must not silently cancel a bring-up or a rejoin
    worker = Worker(dev, chain, data_fn, transport, cfg, threading.Event(),
                    my_spec, chain.flat_layout(), remote=True,
                    incarnation=incarnation, announce=True,
                    hello_payload={"dev": dev, "inc": incarnation,
                                   "host": host, "port": port})
    try:
        worker.run()
    finally:
        worker.hb.stop()
        transport.close()


def cluster_addresses(num_workers: int, host: str = "127.0.0.1",
                      ports: Optional[Iterable[int]] = None
                      ) -> Dict[int, Addr]:
    """Address map for a localhost cluster: the coordinator process hosts
    COORD (-1) and worker 0 on one port; workers 1..N-1 get their own."""
    ps = (list(ports) if ports is not None
          else free_ports(host, num_workers))
    addr_of: Dict[int, Addr] = {-1: (host, ps[0]), 0: (host, ps[0])}
    for dev in range(1, num_workers):
        addr_of[dev] = (host, ps[dev])
    return addr_of


def _spawn_with_pythonpath(procs) -> None:
    """Start processes with the repro_torch package importable in the
    children: spawned interpreters inherit os.environ, not sys.path — make
    sure the package is importable even when the parent got it via
    pytest's `pythonpath` ini option rather than an installed dist or
    $PYTHONPATH."""
    import os

    import repro_torch

    pkg_root = os.path.dirname(os.path.abspath(
        list(repro_torch.__path__)[0]))
    old_pp = os.environ.get("PYTHONPATH")
    parts = [pkg_root] + ([old_pp] if old_pp else [])
    os.environ["PYTHONPATH"] = os.pathsep.join(parts)
    try:
        for p in procs:
            p.start()
    finally:
        if old_pp is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = old_pp


def coordinator_main(spec, cfg, addr_of: Dict[int, Addr],
                     manifest_doc: Optional[dict] = None,
                     resume_state: Optional[dict] = None,
                     numerics: Optional[Dict[str, Any]] = None) -> None:
    """Entry point of a coordinator PROCESS that can itself be SIGKILLed:
    hosts the control plane (``COORD``) plus worker device 0 on
    ``addr_of[0]``, with every other worker expected to run as its own
    process (``worker_main``). The failover demo runs the coordinator
    through this so killing it severs sockets mid-stream; a relaunch with
    the run manifest (``run.Run.resume``) then re-adopts the surviving
    worker processes. ``numerics`` as in ``worker_main``."""
    from repro_torch.runtime.live import COORD, Coordinator

    apply_numerics(numerics)
    chain, batches = spec.build(device=cfg.device)
    transport = SocketTransport(addr_of, local=(COORD, 0), fault=cfg.fault,
                                policy=cfg.wire_policy(),
                                reliable=cfg.reliable_data, rto=cfg.rto,
                                netem=cfg.netem)
    remote = {d for d in addr_of if d > 0}
    coord = Coordinator(chain, lambda gb: batches[gb % len(batches)], cfg,
                        transport=transport, remote_devs=remote,
                        manifest_doc=manifest_doc, resume_state=resume_state)
    try:
        coord.run()
    finally:
        transport.close()


def run_tcp_training(spec, cfg, *, host: str = "127.0.0.1",
                     join_timeout: float = 15.0,
                     manifest_doc: Optional[dict] = None,
                     on_coordinator=None, aggregator=None, chain_id: int = 0,
                     init_flats: Optional[dict] = None,
                     addr_of: Optional[Dict[int, Addr]] = None):
    """Train over real OS processes: coordinator + worker 0 here, workers
    1..N-1 spawned as separate interpreters, all talking TCP through
    ``SocketTransport``. Returns the usual ``LiveResult`` with
    ``worker_exitcodes`` filled in ({dev -> process exit code}; a worker
    SIGKILLed by fault injection reports ``-9``).

    Elastic membership: when ``cfg.rejoin``/``cfg.join_after`` schedule a
    relaunch, the coordinator calls back into this harness (``spawner``)
    and a FRESH process is started for the device — same address for a
    rejoining device (the dead process freed its port), a new port for a
    hot-joined one (its ``hello`` teaches the coordinator the route).
    ``LiveResult.exitcode_history`` then lists every incarnation's exit
    code in launch order (e.g. ``{1: [-9, 0]}`` for SIGKILL-then-rejoin);
    ``worker_exitcodes`` keeps the LAST incarnation per device.

    Fleet hooks (``runtime/fleet.py``): ``aggregator``/``chain_id``/
    ``init_flats`` flow straight into the ``Coordinator`` so this cluster
    can run as ONE CHAIN of a data-parallel fleet; ``addr_of`` lets the
    fleet pre-allocate every chain's port map in one thread (free-port
    probing races when chains launch concurrently). When the chain
    collapses below ``cfg.min_workers`` the raised ``ChainCollapsedError``
    is annotated with the worker exit codes before propagating, so the
    fleet monitor sees the same post-mortem a ``LiveResult`` would carry.

    Every worker process (relaunches included) applies this process's
    ``numerics_settings()``. On CUDA the kernel libraries are built here,
    once, before any child starts, so the children only load them.
    ``LiveResult.startup_s`` is the time from the first spawn to the
    coordinator hearing from the last worker."""
    import multiprocessing as mp

    from repro_torch.runtime.devices import resolve_device
    from repro_torch.runtime.live import (COORD, ChainCollapsedError,
                                          Coordinator)

    if resolve_device(cfg.device).type == "cuda":
        from repro_torch.kernels import build
        build.load("fused_sgd")
        build.load("quant")
    numerics = numerics_settings()
    if addr_of is None:
        addr_of = cluster_addresses(cfg.num_workers, host)
    ctx = mp.get_context("spawn")
    history: Dict[int, list] = {
        dev: [ctx.Process(target=worker_main,
                          args=(dev, addr_of, spec, cfg, 0, numerics),
                          daemon=True)]
        for dev in range(1, cfg.num_workers)}
    t_spawn = time.monotonic()
    _spawn_with_pythonpath([ps[0] for ps in history.values()])

    def spawner(dev: int, incarnation: int) -> None:
        """Launch a new incarnation of `dev` (rejoin) or a first process
        for a never-seen device (hot-join, new port)."""
        child_addr = dict(addr_of)
        if dev not in child_addr:
            child_addr[dev] = (host, free_port(host))
        p = ctx.Process(target=worker_main,
                        args=(dev, child_addr, spec, cfg, incarnation,
                              numerics),
                        daemon=True)
        history.setdefault(dev, []).append(p)
        _spawn_with_pythonpath([p])

    chain, batches = spec.build(device=cfg.device)
    transport = SocketTransport(addr_of, local=(COORD, 0), fault=cfg.fault,
                                policy=cfg.wire_policy(),
                                reliable=cfg.reliable_data, rto=cfg.rto,
                                netem=cfg.netem)
    coord = Coordinator(chain, lambda gb: batches[gb % len(batches)], cfg,
                        transport=transport, remote_devs=set(history),
                        spawner=spawner, manifest_doc=manifest_doc,
                        aggregator=aggregator, chain_id=chain_id,
                        init_flats=init_flats)
    if on_coordinator is not None:
        on_coordinator(coord)            # hand the Run facade its handle
    try:
        res = coord.run()
    except ChainCollapsedError as err:
        _reap(history, join_timeout)
        transport.close()
        err.worker_exitcodes = {dev: ps[-1].exitcode
                                for dev, ps in history.items()}
        err.exitcode_history = {dev: [p.exitcode for p in ps]
                                for dev, ps in history.items()}
        raise
    finally:
        _reap(history, join_timeout)
        transport.close()
    res.worker_exitcodes = {dev: ps[-1].exitcode
                            for dev, ps in history.items()}
    res.exitcode_history = {dev: [p.exitcode for p in ps]
                            for dev, ps in history.items()}
    heard = [t for t, text in res.events
             if text.startswith("remote workers connected")]
    if heard:
        res.startup_s = coord._t0 - t_spawn + heard[0]
    return res


def _reap(history: Dict[int, list], join_timeout: float) -> None:
    """Join (then terminate) every spawned worker process. Idempotent —
    the collapse path runs it before annotating the error, and the
    ``finally`` runs it again as a no-op."""
    for ps in history.values():
        for p in ps:
            p.join(timeout=join_timeout)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
