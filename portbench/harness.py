"""One run of one cell: resolve it by name, set it up, measure its window,
trace a few steps, check what the timed path produced, print the result.

Everything of a cell is found by name in files of its own:
``BENCHMARK.json`` names the cell's configuration and traffic mix;
``configs/<config>.json`` holds the configuration as it is run,
``traffic/<mix>.json`` the mix's parameters and ``kind``,
``traffic/<kind>.py`` the code that drives that kind of work,
``cells/<cell>.json`` the limits of the cell's correctness check, and
``metrics/<metric>.py`` each per-layer metric's reader. An unknown name
fails loudly.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import pathlib
import subprocess
import sys
import time
import types

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

# keys of a configuration file that say where it comes from, not what runs
INFO_KEYS = {"source", "deployment", "departures", "published", "assumed"}
# keys the program has no option for: a file may state them only at the
# value the program implements
FIXED_KEYS = {"tie_word_embeddings": False, "router_z_weight": 0.0,
              "norm_topk_prob": True, "qk_norm": False}
# top-level names a run may not have loaded: JAX and the JAX package
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "ftpipehd"}


class UnknownName(KeyError):
    pass


def load_json(path: pathlib.Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path, tag: str):
    if not path.is_file():
        raise UnknownName(f"no file {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{tag}_{path.stem.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find(entries, name: str, what: str):
    for e in entries:
        if e["name"] == name:
            return e
    raise UnknownName(f"unknown {what} {name!r}; known: "
                      f"{sorted(e['name'] for e in entries)}")


def named_file(base: pathlib.Path, folder: str, name: str,
               suffix: str) -> pathlib.Path:
    path = base / folder / f"{name}{suffix}"
    if not path.is_file():
        raise UnknownName(f"no {folder[:-1]} file {path} for {name!r}")
    return path


@dataclasses.dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with everything it names loaded."""
    name: str
    chips: int
    config: dict
    mix: dict
    kind: types.ModuleType
    limits: dict
    end_to_end: list
    per_layer: list             # [(entry, reader module)]


def reports(entry, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def resolve(bench: dict, name: str, base: pathlib.Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``bench``: its configuration, mix and limits
    read from ``base``, its traffic kind and metric readers from the
    benchmark's own folders."""
    w = find(bench["workloads"], name, "workload")
    find(bench["configs"], w["config"], "configuration")
    config = load_json(named_file(base, "configs", w["config"], ".json"))
    mix = load_json(named_file(base, "traffic", w["traffic"], ".json"))
    kind = load_module(named_file(BENCH_DIR, "traffic", mix["kind"], ".py"),
                       "kind")
    cell = load_json(named_file(base, "cells", name, ".json"))
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    per_layer = []
    for m in bench["per_layer"]:
        if not reports(m, name) and not (
                "workloads" not in m
                and any(e["name"] == m["moves"] for e in e2e)):
            continue
        per_layer.append((m, load_module(
            named_file(BENCH_DIR, "metrics", m["name"], ".py"), "metric")))
    return Cell(name, w["chips"], config, mix, kind, cell.get("limits", {}),
                e2e, per_layer)


def port_config(c: dict):
    """The program's ``ModelConfig`` of a configuration file."""
    from repro_torch.configs.base import ModelConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {}
    for key, value in c.items():
        if key in INFO_KEYS:
            continue
        if key in FIXED_KEYS:
            if value != FIXED_KEYS[key]:
                raise ValueError(f"{c['name']}: the program runs {key} = "
                                 f"{FIXED_KEYS[key]!r} only, not {value!r}")
            continue
        if key not in fields:
            raise ValueError(f"{c['name']}: the program has no setting "
                             f"{key!r}")
        kw[key] = value
    return ModelConfig(**kw)


def check_layout(cfg, params):
    """The benchmark's weights must have the program's tree layout."""
    from repro_torch.models.model import init_params
    from portbench.weights import flatten
    want = [(p, tuple(t.shape), t.dtype) for p, t in
            flatten(init_params(0, cfg, device="meta"))]
    got = [(p, tuple(t.shape), t.dtype) for p, t in flatten(params)]
    if sorted(want, key=str) != sorted(got, key=str):
        raise ValueError(f"the benchmark's weight layout differs from the "
                         f"program's: {set(map(str, want)) ^ set(map(str, got))}")


@dataclasses.dataclass
class RunState:
    """What a traffic kind's driver is given."""
    cell: Cell
    cfg: object                 # the program's ModelConfig
    seed: int
    device: object
    fault: str | None = None


def allocator_counts() -> dict:
    """Cumulative counters of the CUDA caching allocator."""
    import torch
    st = torch.cuda.memory_stats()
    return {k: st.get(k, 0) for k in ("num_alloc_retries", "num_device_alloc",
                                      "num_device_free", "num_ooms")}


def card_name():
    import torch
    return torch.cuda.get_device_name(0)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run(bench: dict, name: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, base: pathlib.Path = BENCH_DIR, device: str = "cuda",
        fault: str | None = None, chip_check: bool = True) -> dict:
    """One run of cell ``name``; returns the result's fields. The tests
    pass ``base`` (a folder of small cells), ``device``, ``fault`` (a
    fault planted under the timed path) and ``chip_check=False``."""
    import torch

    cell = resolve(bench, name, base)
    if chip_check:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: the benchmark runs on the card "
                             "only")
        if torch.cuda.device_count() < cell.chips:
            raise SystemExit(f"{cell.name} needs {cell.chips} CUDA devices, "
                             f"found {torch.cuda.device_count()}")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = port_config(cell.config)
    state = RunState(cell, cfg, seed, dev, fault)
    driver = cell.kind.Driver(state)
    driver.setup()
    sync()
    gc.collect()
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    # ---- the measured window: a closed loop, units back to back ------
    alloc0 = allocator_counts() if cuda else {}
    i = driver.first_unit
    t0 = time.perf_counter()
    returned = []               # host seconds at which each call returned
    while time.perf_counter() - t0 < seconds:
        driver.call(i)
        i += 1
        returned.append(time.perf_counter() - t0)
    sync()
    elapsed = time.perf_counter() - t0
    units = i - driver.first_unit
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    alloc1 = allocator_counts() if cuda else {}
    rate = units * driver.tokens_per_unit / elapsed

    traced = None
    if trace:
        from portbench.trace import capture
        first = i
        traced = capture(lambda k: driver.call(first + k), driver.traced_units)
        i += driver.traced_units
    memory_peak = max(setup_peak, window_peak,
                      torch.cuda.max_memory_allocated() if cuda else 0)
    driver.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    checks = {k: (v, cell.limits[k]) for k, v in driver.readings().items()
              if k in cell.limits}
    correct = all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    failed = sum(1 for v, lim in checks.values()
                 if not (math.isfinite(v) and v <= lim))

    values = {cell.kind.RATE: rate, "peak_mem_gb": window_peak / 1e9,
              "setup_s": setup_s}
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise UnknownName(f"{cell.name}: no reading for end-to-end "
                                  f"metric {m['name']!r}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        ctx = types.SimpleNamespace(
            config=cell.config, mix=cell.mix, kind=cell.kind, trace=traced,
            rate=rate, tokens_per_unit=driver.tokens_per_unit)
        for m, reader in cell.per_layer:
            v = reader.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {
        "correct": correct, "attempted": units, "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else dev.type,
                   "kind": card_name() if cuda else dev.type,
                   "count": cell.chips, "memory_peak_bytes": memory_peak,
                   "power_limit": power_limit() if cuda else "unknown"},
        "window": {"units": units, "seconds": elapsed,
                   "tokens_per_unit": driver.tokens_per_unit,
                   "returned_s": returned,
                   "allocator": {k: alloc1[k] - alloc0[k] for k in alloc1},
                   "reserved_peak_bytes": torch.cuda.max_memory_reserved()
                   if cuda else 0},
    }
    if traced is not None:
        result["device"].update(busy_s=traced.busy_s,
                                window_s=traced.window_s)
        result["breakdown"] = {"device_ops": traced.device_ops(),
                               "idle_gaps": traced.idle_gaps()}
    result["check"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in checks.items()}
    return result


def loaded_forbidden() -> list[str]:
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def main(argv, t_start: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench_path = ROOT / "BENCHMARK.json"
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no program at {ROOT / 'src' / 'repro_torch'}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        result = run(load_json(bench_path), args.workload, args.seed,
                     args.seconds, bool(args.trace), t_start=t_start)
    except UnknownName as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: the run loaded JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 3
    for k, c in result["check"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct = {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
