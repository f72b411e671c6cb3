"""The readers of the program's spans and counters (``spans.py`` and the
eight metrics that use it) on hand-made traces and records, as
``test_portbench_trace.py`` does for the trace; and, on the card, the
program's span stamps against the profiler's own host events."""
import random
import statistics

import pytest

from portbench import harness, spans
from portbench.trace import Trace
from repro_torch import obs

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
READERS = {m["name"]: harness.load_module(
    harness.BENCH_DIR / "metrics" / f"{m['name']}.py", "metric")
    for m in BENCH["per_layer"]}


def read(monkeypatch, name, records, trace):
    monkeypatch.setattr(obs, "records", lambda: records)
    return READERS[name].read(type("Ctx", (), {"trace": trace}))


def span(name, phase="fwd", host=(0, 0), dev=None):
    return obs.Span(name, phase=phase, start_ns=host[0], end_ns=host[1],
                    device_ms=dev)


def train_records():
    """Two steps: Adam 10 and 12 ms, one blend of 3 ms, the expert layer
    forward 4 + 5 ms and its replay 4 ms, its backward 20 ms of which a
    stage's replay covers 8, a backward of 7 ms with no replay in it; the
    head 30 + 40 ms; routes 1000, 150 dropped."""
    return obs.Records(spans=[
        span("engine.optimizer", dev=(100.0, 110.0)),
        span("engine.optimizer", dev=(300.0, 312.0)),
        span("engine.blend", dev=(312.0, 315.0)),
        span("moe", dev=(0.0, 4.0)),
        span("moe", dev=(10.0, 15.0)),
        span("moe", "recompute", dev=(50.0, 54.0)),
        span("engine.stage", "recompute", dev=(48.0, 56.0)),
        span("moe", "bwd", dev=(40.0, 60.0)),
        span("moe", "bwd", dev=(70.0, 77.0)),
        span("head", dev=(20.0, 50.0)),
        span("head", "bwd", dev=(60.0, 100.0)),
        span("engine.train_step"),
    ], counters={"moe.routes": 1000, "moe.routes_dropped": 150})


TRAIN_TRACE = Trace(units=2, t0=0, t1=1, kernels=[], copies=[], host=[])


@pytest.mark.parametrize("name, want", [
    ("adam_ms_per_step.train", 11.0),
    ("blend_ms_per_step.train", 1.5),
    ("moe_fwd_ms_per_step.train", 6.5),
    ("moe_bwd_ms_per_step.train", 9.5),      # (20 - 8 + 7) / 2
    ("head_ms_per_step.train", 35.0),
    ("dropped_route_share.train", 15.0),
])
def test_train_readers(monkeypatch, name, want):
    assert read(monkeypatch, name, train_records(), TRAIN_TRACE) == \
        pytest.approx(want)


def test_no_blend_in_the_traced_steps_reads_zero(monkeypatch):
    rec = train_records()
    rec.spans = [s for s in rec.spans if s.name != "engine.blend"]
    assert read(monkeypatch, "blend_ms_per_step.train", rec,
                TRAIN_TRACE) == 0.0


def prefill_trace():
    """A span of 0..1000 ns, two calls; the device busy 0..100, 300..400,
    550..650: idle 100..300, 400..550, 650..1000."""
    return Trace(units=2, t0=0, t1=1000,
                 kernels=[("k", 0, 100), ("k", 300, 400), ("k", 550, 650)],
                 copies=[], host=[])


def prefill_records():
    """Call 1: engine 0..500, a stage 50..450, blocks 120..250 and
    260..420; call 2: engine 550..900, blocks 560..580 (busy there)."""
    return obs.Records(spans=[
        span("engine.prefill", host=(0, 500)),
        span("engine.stage", host=(50, 450)),
        span("block.attn", host=(120, 250)),
        span("block.ffn", host=(260, 420)),
        span("engine.prefill", host=(550, 900)),
        span("block.attn", host=(560, 580)),
    ], counters={})


def test_idle_split_between_blocks_and_engine(monkeypatch):
    trace, rec = prefill_trace(), prefill_records()
    blocks = read(monkeypatch, "idle_in_blocks_ms_per_call.prefill", rec,
                  trace)
    engine = read(monkeypatch, "idle_in_engine_ms_per_call.prefill", rec,
                  trace)
    # blocks: 120..250 (130) + 260..300 (40) + 400..420 (20) = 190 ns
    assert blocks == pytest.approx(190 / 1e6 / 2)
    # engine, no block: 100..120 (20) + 250..260 (10) + 420..500 (80)
    # + 650..900 (250) = 360 ns; 500..550 and 900..1000 are neither,
    # 550..560 and 560..580 busy
    assert engine == pytest.approx(360 / 1e6 / 2)
    idle = sum(e - s for s, e in spans.idle_gaps(trace))
    assert blocks + engine <= idle / 1e6 / 2


NEW = ["adam_ms_per_step.train", "blend_ms_per_step.train",
       "moe_fwd_ms_per_step.train", "moe_bwd_ms_per_step.train",
       "head_ms_per_step.train", "dropped_route_share.train",
       "idle_in_blocks_ms_per_call.prefill",
       "idle_in_engine_ms_per_call.prefill"]


@pytest.mark.parametrize("name", NEW)
def test_no_records_read_none(monkeypatch, name):
    trace = prefill_trace()
    assert read(monkeypatch, name, obs.Records([], {}), trace) is None
    if name.endswith(".train") and name != "dropped_route_share.train":
        # host spans alone (a run on the CPU): no device markers
        rec = obs.Records([span("engine.optimizer"), span("moe")], {})
        assert read(monkeypatch, name, rec, trace) is None


def brute(a, b, n):
    """Lengths on the integer grid 0..n: |a ∩ b| and the cells of a - b."""
    ina = [any(s <= x < e for s, e in a) for x in range(n)]
    inb = [any(s <= x < e for s, e in b) for x in range(n)]
    return (sum(p and q for p, q in zip(ina, inb)),
            [p and not q for p, q in zip(ina, inb)])


@pytest.mark.parametrize("seed", range(20))
def test_interval_arithmetic_against_the_grid(seed):
    rng = random.Random(seed)
    n = 60

    def draw():
        out = []
        for _ in range(rng.randrange(0, 7)):
            s = rng.randrange(0, n)
            out.append((s, min(n, s + rng.randrange(0, 15))))
        return out

    a, b = spans.union(draw()), spans.union(draw())
    both, rest = brute(a, b, n)
    assert spans.overlap(a, b) == both
    assert brute(spans.minus(a, b), [], n)[1] == rest
    merged = spans.union(a + b)
    assert all(m[1] < merged[i + 1][0] for i, m in enumerate(merged[:-1]))


@pytest.mark.card
def test_span_stamps_agree_with_the_profiler(card):
    """A pipelined prefill on the card under the profiler: each block
    span holds the aten operations whose middle falls in it to within
    100 us at either end, on the profiler's own stamps. Prints the lead
    (first operation's start after the span's) and lag (span's end after
    the last operation's) in us."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.pipeline import pipeline_step as ps

    cfg = get_config("qwen2-1.5b").reduced(pipeline_stages=2, num_layers=4,
                                           use_flash_attention=0)
    mesh = make_debug_mesh(1, 2, 1, device=card)
    step = ps.make_prefill_step(mesh, cfg, num_microbatches=2)
    params = M.init_params(0, cfg, device=card)
    tokens = torch.randint(0, cfg.vocab_size, (4, 256), device=card)
    with torch.no_grad():
        step(params, {"tokens": tokens})
        torch.cuda.synchronize()
        obs.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                step(params, {"tokens": tokens})
            torch.cuda.synchronize()
    blocks = [s for s in obs.records().spans if s.name.startswith("block.")]
    assert len(blocks) == 4 * 2 * cfg.num_layers * 2
    aten = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("aten::")
                  and e.device_type() != torch.autograd.DeviceType.CUDA)
    leads, lags = [], []
    for s in blocks:
        inside = [(a, b) for a, b in aten
                  if s.start_ns <= (a + b) // 2 <= s.end_ns]
        assert inside
        leads.append((min(a for a, _ in inside) - s.start_ns) / 1e3)
        lags.append((s.end_ns - max(b for _, b in inside)) / 1e3)
    print(f"span stamps against the profiler's, us: lead min "
          f"{min(leads):.1f} median {statistics.median(leads):.1f} max "
          f"{max(leads):.1f}; lag min {min(lags):.1f} median "
          f"{statistics.median(lags):.1f} max {max(lags):.1f}")
    assert min(leads) >= -100 and min(lags) >= -100
    assert statistics.median(leads) <= 100 and statistics.median(lags) <= 100
