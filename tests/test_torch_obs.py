"""The port's span and counter recorder (``repro_torch.obs``) and its
sites in the engine, on the CPU: recording changes nothing of what the
engine computes or saves, each step records the spans the benchmark's
readers expect, nested as they expect, the route counters agree with
``dispatch``, the spans sit on the profiler's clock, and the port opens
no ``record_function`` range (the profiler would copy one onto the
device's track). No assertion rests on a duration."""
import collections

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402,E501

from repro_torch import obs, tree  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.pipeline import pipeline_step as ps  # noqa: E402

STEPS, M_B, S = 3, 2, 2          # steps, microbatches, stages
ARCHS = {"dense": "qwen2-1.5b", "moe": "olmoe-1b-7b"}
# a quarter of the routes an expert would take: most tokens overflow
DROPPING = dict(capacity_factor=0.25)


def _cfg(family, **kw):
    return get_config(ARCHS[family]).reduced(
        pipeline_stages=S, num_layers=4, stash_depth=2, aggregate_every=2,
        **kw)


def _batches(cfg, n=STEPS):
    g = torch.Generator().manual_seed(1)
    return [{"tokens": torch.randint(0, cfg.vocab_size, (4, 16), generator=g),
             "labels": torch.randint(0, cfg.vocab_size, (4, 16), generator=g)}
            for _ in range(n)]


def _train(cfg, record: bool):
    """Three steps (stash 2, blend at step 2, remat) from seed-0 weights:
    the final state and each step's metrics."""
    mesh = make_debug_mesh(1, S, 1, device="cpu")
    tc = TrainConfig(learning_rate=1e-3, optimizer="adam",
                     microbatches=M_B, remat=True)
    step, _ = ps.make_train_step(mesh, cfg, tc)
    state = step.init_state(M.init_params(0, cfg, device="cpu"))
    metrics = []
    ctx = obs.recording() if record else _nothing()
    with ctx:
        for batch in _batches(cfg):
            state, m = step(state, batch)
            metrics.append(m)
    return state, metrics


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def _graph(total):
    """The names of the autograd nodes reachable from ``total``."""
    seen, names, todo = set(), collections.Counter(), [total.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names[type(fn).__name__] += 1
        todo += [f for f, _ in fn.next_functions]
    return names


def _loss_graph(cfg, remat: bool):
    """(total, autograd node names, tensors saved outside remat) of one
    loss on seed-0 weights."""
    mesh = make_debug_mesh(1, S, 1, device="cpu")
    loss_fn = ps.make_loss_fn(mesh, cfg, num_microbatches=M_B, remat=remat)
    params = tree.map(lambda t: t.detach().requires_grad_(True),
                      M.init_params(0, cfg, device="cpu"))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(1) or t, lambda t: t):
        total, _ = loss_fn(params, _batches(cfg, 1)[0])
    return total, _graph(total), len(saved)


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_recording_off_leaves_the_step_as_it_was(family):
    cfg = _cfg(family, **(DROPPING if family == "moe" else {}))
    obs.reset()
    off, m_off = _train(cfg, record=False)
    assert obs.records().spans == [] and obs.records().counters == {}
    on, m_on = _train(cfg, record=True)
    assert obs.records().spans
    for key in ("params", "stash", "opt_state"):
        leaves, paths = tree.flatten(off[key])
        for path, a, b in zip(paths, leaves, tree.leaves(on[key])):
            assert torch.equal(a, b), (key, path)
    assert torch.equal(off["step"], on["step"])
    for a, b in zip(m_off, m_on):
        assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("family", ["dense", "moe"])
def test_recording_adds_only_its_marks_to_the_graph(family, remat):
    cfg = _cfg(family)
    total_off, off, saved_off = _loss_graph(cfg, remat)
    assert "_MarkBackward" not in off
    with obs.recording():
        total_on, on, saved_on = _loss_graph(cfg, remat)
    marks = on.pop("_MarkBackward")
    # head: in and out; moe: in and out a layer a microbatch
    assert marks == 2 + (2 * cfg.num_layers * M_B if family == "moe" else 0)
    assert on == off
    assert saved_on == saved_off
    assert torch.equal(total_on, total_off)


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_each_step_records_its_spans_nested(family):
    cfg = _cfg(family, **(DROPPING if family == "moe" else {}))
    _train(cfg, record=True)
    spans = obs.records().spans
    units = sorted({s.unit for s in spans})
    assert len(units) == STEPS
    layers_mb = cfg.num_layers * M_B
    for i, u in enumerate(units):
        got = collections.Counter((s.name, s.phase) for s in spans
                                  if s.unit == u)
        want = {("engine.train_step", "fwd"): 1,
                ("engine.optimizer", "fwd"): 1,
                ("engine.stage", "fwd"): S * M_B,
                ("engine.stage", "recompute"): S * M_B,
                ("block.attn", "fwd"): layers_mb,
                ("block.attn", "recompute"): layers_mb,
                ("block.ffn", "fwd"): layers_mb,
                ("block.ffn", "recompute"): layers_mb,
                ("head", "fwd"): 1, ("head", "bwd"): 1}
        if (i + 1) % cfg.aggregate_every == 0:
            want[("engine.blend", "fwd")] = 1
        if family == "moe":
            want.update({("moe", "fwd"): layers_mb,
                         ("moe", "recompute"): layers_mb,
                         ("moe", "bwd"): layers_mb})
        assert dict(got) == want
    parents = {"engine.train_step": None, "engine.optimizer":
               "engine.train_step", "engine.blend": "engine.train_step",
               "engine.stage": "engine.train_step", "block.attn":
               "engine.stage", "block.ffn": "engine.stage",
               "head": "engine.train_step"}
    for s in spans:
        assert s.start_ns <= s.end_ns and s.device_ms is None
        if s.name == "moe":
            want = "engine.train_step" if s.phase == "bwd" else "block.ffn"
        else:
            want = parents[s.name]
        assert (s.parent.name if s.parent else None) == want, s
        assert s.parent is None or s.parent.unit == s.unit


def test_route_counters_match_dispatch():
    cfg = _cfg("moe", **DROPPING)
    g = torch.Generator().manual_seed(3)
    p = moe_lib.init_moe(g, cfg)
    xs = [torch.randn((2, 16, cfg.d_model), generator=g) for _ in range(3)]
    routes = dropped = 0
    for x in xs:
        xt = x.reshape(-1, cfg.d_model)
        _, _, top_e = moe_lib.route(p["router"], xt, cfg.moe_top_k)
        keep, _, _ = moe_lib.dispatch(top_e, cfg.num_experts,
                                      moe_lib.capacity(xt.shape[0], cfg))
        routes += top_e.numel()
        dropped += int((~keep).sum())
    assert 0 < dropped < routes
    with obs.recording():
        for x in xs:
            moe_lib.moe_ffn(p, x, cfg=cfg, dtype=torch.float32)
        counters = obs.records().counters
    assert counters == {"moe.routes": routes, "moe.routes_dropped": dropped}


def _prefill(cfg):
    mesh = make_debug_mesh(1, S, 1, device="cpu")
    step = ps.make_prefill_step(mesh, cfg, num_microbatches=M_B)
    params = M.init_params(0, cfg, device="cpu")
    batch = {"tokens": _batches(cfg, 1)[0]["tokens"]}
    return lambda: step(params, batch)


def test_spans_sit_on_the_profilers_clock():
    """The profiler alone switches recording on; the call's root span lies
    inside the test's range and contains the aten operations of the
    call, within 1 ms, on the profiler's own stamps (an order, not a
    duration: the host may pause anywhere)."""
    cfg = _cfg("dense")
    call = _prefill(cfg)
    with torch.no_grad():
        call()
        obs.reset()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("test.call"):
                call()
    root = [s for s in obs.records().spans if s.name == "engine.prefill"]
    assert len(root) == 1
    root = root[0]
    events = prof.profiler.kineto_results.events()
    (t0, t1), = [(e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in events if e.name() == "test.call"]
    aten = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
            if e.name().startswith("aten::") and t0 <= e.start_ns() <= t1]
    assert aten
    slack = 1_000_000
    assert t0 - slack <= root.start_ns <= root.end_ns <= t1 + slack
    assert all(root.start_ns - slack <= s and e <= root.end_ns + slack
               for s, e in aten)
    blocks = [s for s in obs.records().spans if s.name.startswith("block.")]
    assert len(blocks) == 2 * cfg.num_layers * M_B
    assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
               for s in blocks)


def test_the_port_opens_no_record_function_range():
    cfg = _cfg("moe")
    mesh = make_debug_mesh(1, S, 1, device="cpu")
    tc = TrainConfig(learning_rate=1e-3, optimizer="adam",
                     microbatches=M_B, remat=True)
    step, _ = ps.make_train_step(mesh, cfg, tc)
    state = step.init_state(M.init_params(0, cfg, device="cpu"))
    call = _prefill(cfg)
    obs.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.call"):
            for batch in _batches(cfg, 2):
                state, _ = step(state, batch)
            with torch.no_grad():
                call()
    assert {s.name for s in obs.records().spans} >= {
        "engine.train_step", "engine.prefill", "moe", "head"}
    annotations = {e.name for e in prof.events() if e.is_user_annotation}
    assert annotations == {"test.call"}


def test_off_is_one_shared_no_op():
    obs.reset()
    x = torch.ones(3, requires_grad=True)
    assert obs.span("a") is obs.span("b", device="cpu")
    assert obs.unit("engine.train_step") is obs.span("c")
    assert obs.grad_mark(x, "moe", "in") is x
    obs.count("moe.routes", 3)
    obs.count_tensor("moe.routes_dropped", x, len)
    assert obs.records().spans == [] and obs.records().counters == {}


def test_recording_clears_on_entry_and_reading_does_not():
    with obs.recording():
        with obs.span("a"):
            obs.count("c", 2)
        assert len(obs.records().spans) == 1
        assert obs.records().counters == {"c": 2}
    assert len(obs.records().spans) == 1
    with obs.recording():
        assert obs.records().spans == [] and obs.records().counters == {}


def test_threads_lose_no_record():
    """More threads than cores, switching often: every span and count
    lands, and each span's parent is the one its own thread opened."""
    import sys
    import threading

    n_threads, n = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with obs.recording():
            def work(k):
                for _ in range(n):
                    with obs.span(f"outer{k}"):
                        with obs.span(f"inner{k}"):
                            obs.count("c", 1)
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            rec = obs.records()
    finally:
        sys.setswitchinterval(old)
    assert rec.counters == {"c": n_threads * n}
    assert len(rec.spans) == 2 * n_threads * n
    for s in rec.spans:
        if s.name.startswith("inner"):
            assert s.parent.name == "outer" + s.name[len("inner"):]
        else:
            assert s.parent is None
