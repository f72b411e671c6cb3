"""The port's multi-process TCP transport (``repro_torch.runtime.net``):
the frame-level cases of ``tests/test_net.py`` on real localhost sockets,
wire parity with the JAX package's ``SocketTransport`` (each side receives
the other's frames intact, on the ``off`` and ``int8-fused`` tiers),
numerics settings carried into spawned workers, and the multi-process
runs on the CPU: a failure-free TCP run against the queue run of the same
config (per-batch losses rtol 1e-5, atol 1e-6, the reference's limit), a
SIGKILLed worker process with the queue run's partitions and recovery,
and a kill + rejoin that relaunches the process.

Every wait is bounded. Runs that must not see a false failure detection
use a detect timeout well above any heartbeat gap a loaded machine gives.
"""
import concurrent.futures
import multiprocessing as mp
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.runtime import net as ref_net  # noqa: E402
from repro.runtime.codec import WirePolicy as RefPolicy  # noqa: E402
from repro.runtime.qtensor import DeviceQuantized as RefQuantized  # noqa: E402
from repro_torch.runtime import net  # noqa: E402
from repro_torch.runtime.codec import WirePolicy  # noqa: E402
from repro_torch.runtime.devices import (DeviceSpec, WorkloadProfile,  # noqa: E402
                                         uniform_bandwidth)
from repro_torch.runtime.live import COORD, LiveConfig, run_live_training  # noqa: E402
from repro_torch.runtime.net import (SocketTransport, cluster_addresses,  # noqa: E402
                                     free_port, parse_peers,
                                     run_tcp_training)
from repro_torch.runtime.protocol import ProtocolConfig  # noqa: E402
from repro_torch.runtime.qtensor import DeviceQuantized  # noqa: E402
from repro_torch.runtime.transport import FaultSpec  # noqa: E402
from repro_torch.runtime.workload import WorkloadSpec  # noqa: E402

HOST = "127.0.0.1"


def _pair(**kw):
    """Two SocketTransports on localhost: the coordinator side (COORD and
    dev 0) and a single-node worker side (dev 1)."""
    addr_of = cluster_addresses(2, HOST)
    return (SocketTransport(addr_of, local=(COORD, 0), **kw),
            SocketTransport(addr_of, local=(1,), **kw))


def _close(*ts):
    for t in ts:
        if t is not None:
            t.close()


def _wait_for(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.02)
    return pred()


# ----------------------------- frame level --------------------------------

def test_loopback_and_cross_process_round_trip():
    a, b = _pair()
    try:
        x = np.arange(64, dtype=np.float32)
        assert a.send(COORD, 0, "install", {"range": (0, 3),
                                            "layers": {0: x}})
        m = a.recv(0, timeout=1.0)
        assert m.kind == "install" and m.payload["range"] == (0, 3)
        assert m.payload["layers"][0] is not x      # a decoded copy
        np.testing.assert_array_equal(m.payload["layers"][0], x)
        assert a.send(0, 1, "act", (4, 2, x))
        m = b.recv(1, timeout=5.0)
        assert m.kind == "act" and m.payload[:2] == (4, 2)
        np.testing.assert_array_equal(m.payload[2], x)
        b.send(1, COORD, "hb", {"t": 0.5})
        m = a.recv(COORD, timeout=5.0)
        assert (m.kind, m.src, m.dst) == ("hb", 1, COORD)
    finally:
        _close(a, b)


def test_tensor_payload_crosses_as_host_array():
    """A torch tensor is copied to the host by the codec: the receiver
    gets a numpy array with the same values."""
    a, b = _pair()
    try:
        t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
        assert a.send(0, 1, "act", (1, 0, t))
        m = b.recv(1, timeout=5.0)
        assert isinstance(m.payload[2], np.ndarray)
        np.testing.assert_array_equal(m.payload[2], t.numpy())
    finally:
        _close(a, b)


def test_kill_fences_both_directions():
    a, b = _pair()
    try:
        a.kill(1)
        assert not a.send(0, 1, "act", (0, 0, None))
        assert a.stats["to_dead"] == 1
        b.send(1, COORD, "hb", {"t": 1.0})       # zombie traffic
        assert _wait_for(lambda: a.stats["to_dead"] >= 2)
        assert a.recv(COORD, timeout=0.2) is None
        a.revive(1)
        b.send(1, COORD, "hb", {"t": 2.0})
        m = a.recv(COORD, timeout=5.0)
        assert m is not None and m.kind == "hb"
    finally:
        _close(a, b)


def test_reconnect_with_backoff_delivers_to_late_listener():
    ports = net.free_ports(HOST, 2)
    addr_of = {10: (HOST, ports[0]), 11: (HOST, ports[1])}
    s1, s2 = SocketTransport(addr_of, local=(10,)), None
    try:
        assert s1.send(10, 11, "hello", {"dev": 10})
        time.sleep(0.4)                          # several failed dials
        s2 = SocketTransport(addr_of, local=(11,))
        m = s2.recv(11, timeout=10.0)
        assert m is not None and m.kind == "hello"
    finally:
        _close(s1, s2)


def test_frames_to_dead_address_expire_not_block():
    ports = net.free_ports(HOST, 2)
    addr_of = {0: (HOST, ports[0]), 1: (HOST, ports[1])}
    s = SocketTransport(addr_of, local=(0,), retry_window=0.3)
    try:
        assert s.send(0, 1, "probe", {})
        assert _wait_for(lambda: s.stats["net_dropped"] == 1, timeout=5.0)
    finally:
        s.close()


def test_fault_drop_applies_on_send_path():
    addr_of = cluster_addresses(2, HOST)
    a = SocketTransport(addr_of, local=(COORD, 0),
                        fault=FaultSpec(drop=1.0, protect=("ctl",)))
    try:
        assert not a.send(COORD, 0, "data", {})
        assert a.send(COORD, 0, "ctl", {})
        assert a.recv(0, timeout=1.0).kind == "ctl"
    finally:
        a.close()


def test_hello_crosses_kill_fence_with_payload_intact():
    a, b = _pair()
    try:
        a.kill(1)
        assert not a.send(0, 1, "probe", {})
        b.send(1, COORD, "hb", {"t": 1.0})       # zombie traffic: dropped
        b.send(1, COORD, "hello", {"dev": 1, "inc": 2, "host": HOST,
                                   "port": 9})
        m = a.recv(COORD, timeout=5.0)
        assert m is not None and m.kind == "hello" and m.payload["inc"] == 2
    finally:
        _close(a, b)


def test_add_route_reaches_late_joiner():
    ports = net.free_ports(HOST, 3)
    addr_of = cluster_addresses(2, HOST, ports=ports[:2])
    a = SocketTransport(addr_of, local=(COORD, 0))
    c = SocketTransport({**addr_of, 5: (HOST, ports[2])}, local=(5,))
    try:
        assert a.send(0, 5, "probe", {})          # no route: dropped
        assert c.recv(5, timeout=0.3) is None
        a.add_route(5, (HOST, ports[2]))
        assert a.addresses()[5] == (HOST, ports[2])
        assert a.send(0, 5, "admit", {"dev": 5, "inc": 1})
        m = c.recv(5, timeout=5.0)
        assert m is not None and m.kind == "admit"
    finally:
        _close(a, c)


def test_sender_reconnects_to_relaunched_listener():
    """After the peer's listener dies with the connection half-open, a
    frame to the SAME address reaches a relaunched listener."""
    p0, p1 = net.free_ports(HOST, 2)
    addr_of = {0: (HOST, p0), 1: (HOST, p1)}
    a = SocketTransport(addr_of, local=(0,))
    first, second = SocketTransport(addr_of, local=(1,)), None
    try:
        assert a.send(0, 1, "act", (1, 0, np.zeros(4, np.float32)))
        assert first.recv(1, timeout=5.0) is not None
        first.close()                        # the old incarnation dies
        time.sleep(0.3)
        second = SocketTransport(addr_of, local=(1,))   # same port
        a.send(0, 1, "fetch_res", {"req_id": 1, "layers": {}})
        m = second.recv(1, timeout=10.0)
        assert m is not None and m.kind == "fetch_res"
    finally:
        _close(a, first, second)


class _LateAppend(list):
    """A transport's list of accepted connections whose ``append`` waits
    (for ``go``, at most 2 s): it holds the accept thread between taking
    a connection and recording it, the window a loaded machine opens."""

    def __init__(self):
        super().__init__()
        self.go = threading.Event()

    def append(self, item):
        self.go.wait(2.0)
        super().append(item)


def test_close_shuts_a_connection_recorded_late():
    """The race behind the intermittent failure above, made to happen:
    the listener's reader delivers the first frame before the accept
    thread records the connection, and the listener closes in between.
    Its close must still shut that connection down, or the sender sees
    no EOF and writes the next frame into the dead incarnation instead
    of redialling the relaunched one."""
    p0, p1 = net.free_ports(HOST, 2)
    addr_of = {0: (HOST, p0), 1: (HOST, p1)}
    a = SocketTransport(addr_of, local=(0,))
    first, second = SocketTransport(addr_of, local=(1,)), None
    first._readers = gate = _LateAppend()
    try:
        assert a.send(0, 1, "act", (1, 0, np.zeros(4, np.float32)))
        assert first.recv(1, timeout=10.0) is not None
        first.close()                        # the old incarnation dies
        gate.go.set()
        second = SocketTransport(addr_of, local=(1,))   # same port
        a.send(0, 1, "fetch_res", {"req_id": 1, "layers": {}})
        m = second.recv(1, timeout=5.0)
        assert m is not None and m.kind == "fetch_res"
    finally:
        _close(a, first, second)


def test_flush_delivers_what_close_would_drop():
    """A graceful end's last frames (the workers' ``stop``) reach the
    peer: ``flush`` waits until the sender thread has written them, where
    ``close`` right after the send drops a frame not written yet (here
    the receiver listens only 0.3 s after the send, so the sender is in
    its reconnect backoff when the run ends)."""
    p0, p1 = net.free_ports(HOST, 2)
    addr_of = {COORD: (HOST, p0), 0: (HOST, p0), 1: (HOST, p1)}
    a, b = SocketTransport(addr_of, local=(COORD, 0)), None
    try:
        assert a.send(COORD, 1, "stop", {})
        time.sleep(0.3)
        b = SocketTransport(addr_of, local=(1,))
        assert a.flush(timeout=10.0)
        a.close()
        m = b.recv(1, timeout=5.0)
        assert m is not None and m.kind == "stop"
    finally:
        _close(a, b)


def test_coalesced_frames_all_arrive_in_order():
    a, b = _pair()
    try:
        n = 200
        for i in range(n):
            a.send(0, 1, "act", (7, i, None))
        got = [b.recv(1, timeout=5.0) for _ in range(n)]
        assert all(m is not None for m in got)
        assert [m.payload[1] for m in got] == list(range(n))
    finally:
        _close(a, b)


def test_parse_peers_expands_coord():
    got = parse_peers("coord=10.0.0.1:9000, 1=10.0.0.2:9001,"
                      "2=10.0.0.3:9002")
    assert got == {-1: ("10.0.0.1", 9000), 0: ("10.0.0.1", 9000),
                   1: ("10.0.0.2", 9001), 2: ("10.0.0.3", 9002)}
    with pytest.raises(ValueError):
        parse_peers("1=nohost")


def test_cluster_addresses_are_distinct_and_free():
    addr_of = cluster_addresses(6, HOST)
    assert addr_of[COORD] == addr_of[0]
    ports = [addr_of[d][1] for d in range(6)]
    assert len(set(ports)) == 6
    for p in ports:                          # each can be bound now
        s = net._probe(HOST, p)
        assert s is not None
        s.close()
    assert free_port(HOST) > 0


def test_socket_transport_kind_breakdown():
    """Per-kind stats attribute wire volume to act / grad / replica /
    control at the receiver, consistent with the coarser counters."""
    a, b = _pair()
    try:
        x = np.arange(64, dtype=np.float32)
        a.send(0, 1, "act", (0, 0, x))
        a.send(0, 1, "grad", (0, 0, x))
        a.send(0, 1, "grad", (0, 1, x))
        a.send(0, 1, "chain_put", {"layers": {0: x}})
        a.send(0, 1, "hb", {"t": 0.1})
        for _ in range(5):
            assert b.recv(1, timeout=5.0) is not None
        km, kb = b.stats["kind_msgs"], b.stats["kind_bytes"]
        assert km == {"act": 1, "grad": 2, "replica": 1, "replica_ov": 0,
                      "control": 1}
        assert kb["grad"] > kb["act"] > 0
        assert sum(kb.values()) == b.stats["bytes"]
        assert sum(km.values()) == b.stats["delivered"]
        assert kb["act"] + kb["grad"] == b.stats["data_bytes"]
        assert kb["replica"] == b.stats["replica_bytes"]
    finally:
        _close(a, b)


def test_lossy_socket_transport_delivers_exactly_once():
    """The seq/ack retransmit window over real sockets (reliable wire)."""
    ports = net.free_ports(HOST, 2)
    addr_of = {0: (HOST, ports[0]), 1: (HOST, ports[1])}
    a = SocketTransport(addr_of, local=(0,),
                        fault=FaultSpec(drop=0.3, seed=3), reliable=True,
                        rto=0.05)
    b = SocketTransport(addr_of, local=(1,), reliable=True, rto=0.05)
    try:
        n = 20
        for i in range(n):
            a.send(0, 1, "act", {"i": i, "x": np.float32(i)})
        got, deadline = [], time.monotonic() + 20.0
        while len(got) < n and time.monotonic() < deadline:
            m = b.recv(1, timeout=0.05)
            if m is not None:
                got.append(m)
        assert [int(m.payload["i"]) for m in got] == list(range(n))
        assert a.stats["retransmits"] > 0
    finally:
        _close(a, b)


# ------------------------ wire parity with the reference ------------------

def _frames(qt_cls, tier):
    """(kind, src-relative payload) of each class: act, grad, replica and
    control. On ``int8-fused`` the data plane carries quantized codes as
    the stage executors emit them."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 5)).astype(np.float32)
    if tier == "int8-fused":
        q = rng.integers(0, 256, size=30, dtype=np.uint8).tobytes()
        lo = rng.standard_normal(5).astype("<f4").tobytes()
        sc = rng.random(5).astype("<f4").tobytes()
        data = qt_cls(shape=(6, 5), data=q, lo=lo, scale=sc)
    else:
        data = x
    return [("act", (3, 11, data)),
            ("grad", (3, 10, data)),
            ("chain_put", {"batch": 8, "layers": {0: x, 2: x[:2]}}),
            ("segment", {"stage": 1, "n": 3, "b0": 4, "nb": 6,
                         "stage_devs": [0, 1, 2], "seg_id": 2,
                         "addrs": {"1": ["127.0.0.1", 9001]}}),
            ("hb", {"t": 1.5, "busy": 0.25})]


def _same(got, want):
    if isinstance(want, (RefQuantized, DeviceQuantized)):
        assert type(got).__name__ == "DeviceQuantized"
        assert (got.shape, got.data, got.lo, got.scale) == \
            (want.shape, want.data, want.lo, want.scale)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        assert got == want


@pytest.mark.parametrize("sender", ["port", "reference"])
@pytest.mark.parametrize("tier", ["off", "int8-fused"])
def test_wire_parity_with_reference_socket_transport(tier, sender):
    addr_of = cluster_addresses(2, HOST)
    port_t = SocketTransport(addr_of, local=(COORD, 0),
                             policy=WirePolicy(data=tier))
    ref_t = ref_net.SocketTransport(addr_of, local=(1,),
                                    policy=RefPolicy(data=tier))
    try:
        if sender == "port":
            tx, rx, src, dst = port_t, ref_t, 0, 1
            frames = _frames(DeviceQuantized, tier)
        else:
            tx, rx, src, dst = ref_t, port_t, 1, 0
            frames = _frames(RefQuantized, tier)
        for kind, payload in frames:
            assert tx.send(src, dst, kind, payload)
        for kind, payload in frames:
            m = rx.recv(dst, timeout=5.0)
            assert m is not None, kind
            assert (m.kind, m.src, m.dst) == (kind, src, dst)
            _same(m.payload, payload)
        if tier == "int8-fused":          # codes cost a byte an element
            assert rx.stats["kind_bytes"]["act"] < 30 * 4
    finally:
        _close(port_t, ref_t)


# ---------------------- numerics settings across spawn --------------------

def test_spawned_child_applies_the_captured_numerics():
    """A spawned interpreter starts with torch's defaults; what
    ``numerics_settings`` captured is what ``apply_numerics`` installs
    there (the settings every worker process of a TCP run gets)."""
    want = {"cudnn_deterministic": True, "cudnn_benchmark": True,
            "cudnn_allow_tf32": False, "matmul_allow_tf32": True,
            "num_threads": 1}
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=1, mp_context=mp.get_context("spawn"),
            initializer=net.apply_numerics, initargs=(want,)) as pool:
        got = pool.submit(net.numerics_settings).result(timeout=120)
    assert got == want
    here = net.numerics_settings()
    assert here["num_threads"] == 2 and set(here) == set(want)


# ----------------------- multi-process runs (CPU) -------------------------

def _fixed_profile(num_layers=8):
    """With capacity_source='spec' every partition and recovery decision
    is a pure function of the config, so queue and TCP runs agree."""
    return WorkloadProfile(fwd_times=np.full(num_layers, 1e-3),
                           bwd_times=np.full(num_layers, 2e-3),
                           out_bytes=np.full(num_layers, 1024.0),
                           weight_bytes=np.full(num_layers, 2048.0))


def _parity_cfg(**kw):
    d = dict(
        num_workers=3, num_batches=22,
        protocol=ProtocolConfig(chain_every=8, global_every=16,
                                repartition_first_at=5,
                                repartition_every=10_000,
                                detect_timeout=2.0),
        lr=0.1,
        device_specs=[DeviceSpec("central", 1.0), DeviceSpec("peer", 1.0),
                      DeviceSpec("slow", 4.0)],
        bandwidth=uniform_bandwidth(3, 1e9),
        profile=_fixed_profile(), capacity_source="spec", device="cpu")
    d.update(kw)
    return LiveConfig(**d)


def _points(parts):
    return [tuple(int(p) for p in pts) for _, pts in parts]


SPEC = WorkloadSpec(kind="mlp", seed=0, num_layers=8)


@pytest.mark.live
def test_tcp_matches_queue_losses_without_faults():
    """No faults, quiet cadences: crossing a process boundary changes
    nothing about the math."""
    cfg = LiveConfig(num_workers=3, num_batches=10,
                     protocol=ProtocolConfig(chain_every=10_000,
                                             global_every=10_000,
                                             repartition_first_at=10_000,
                                             repartition_every=10_000,
                                             detect_timeout=5.0),
                     lr=0.1, device="cpu")
    chain, batches = SPEC.build(device="cpu")
    ref = run_live_training(chain, batches, cfg)
    got = run_tcp_training(SPEC, cfg)
    assert got.worker_exitcodes == {1: 0, 2: 0}
    assert not got.recoveries and not ref.recoveries
    np.testing.assert_allclose(got.losses, ref.losses, rtol=1e-5, atol=1e-6)
    assert 0.0 < got.startup_s < 120.0
    kb = got.transport_stats["kind_bytes"]
    assert kb["grad"] > 0 and kb["control"] > 0


@pytest.mark.live
def test_tcp_sigkill_parity_with_queue_transport():
    """A coordinator + 2 worker PROCESSES survive a SIGKILLed worker, and
    every protocol decision — initial partition, §III-D re-partition,
    §III-F recovery partition, evicted device — equals the queue run's."""
    chain, batches = SPEC.build(device="cpu")
    queue_res = run_live_training(chain, batches, _parity_cfg(kill=(1, 9)))
    tcp_res = run_tcp_training(SPEC, _parity_cfg(kill=(1, 9)))
    assert tcp_res.worker_exitcodes == {1: -9, 2: 0}
    for res in (queue_res, tcp_res):
        assert not np.isnan(res.losses).any()
        assert len(res.recoveries) == 1
        assert res.recoveries[0]["failed"] == [1]
    assert _points(queue_res.partitions) == _points(tcp_res.partitions)
    assert len(tcp_res.partitions) >= 3    # initial, re-partition, recovery
    assert tuple(int(p) for p in queue_res.recoveries[0]["partition"]) \
        == tuple(int(p) for p in tcp_res.recoveries[0]["partition"])
    untrained = float(np.median(queue_res.losses[:3]))
    for res in (queue_res, tcp_res):
        assert float(np.median(res.losses[-4:])) < 0.7 * untrained


@pytest.mark.live
def test_tcp_rejoin_relaunches_the_killed_process():
    """Kill worker 1 at batch 9 and relaunch it at 13: a fresh process
    with a bumped incarnation is admitted and the pipeline expands back,
    with the queue run's partitions and admission."""
    cfg = _parity_cfg(num_batches=24, kill=(1, 9), rejoin=(1, 13),
                      join_wait=90)
    chain, batches = SPEC.build(device="cpu")
    queue_res = run_live_training(chain, batches, cfg)
    tcp_res = run_tcp_training(SPEC, cfg)
    assert tcp_res.exitcode_history == {1: [-9, 0], 2: [0]}
    for res in (queue_res, tcp_res):
        assert not np.isnan(res.losses).any()
        assert len(res.recoveries) == 1 and len(res.admissions) == 1
        assert len(res.final_partition) == 3
    assert _points(queue_res.partitions) == _points(tcp_res.partitions)
    for key in ("devs", "incs"):
        assert queue_res.admissions[0][key] == tcp_res.admissions[0][key]
    assert tuple(int(p) for p in queue_res.admissions[0]["partition"]) \
        == tuple(int(p) for p in tcp_res.admissions[0]["partition"])
