"""``BENCHMARK.json`` against the contract's form, and every name in it
found in a file of its own; an unknown name fails loudly."""
import json
import re

import pytest

from portbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_entries():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    assert len(e2e | {m["name"] for m in BENCH["per_layer"]}) == \
        len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = harness.resolve(BENCH, cell)
    assert c.kind.RATE in {m["name"] for m in c.end_to_end}
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "peak_mem_gb"}
    assert c.per_layer and c.limits
    for entry, reader in c.per_layer:
        assert (reader.UNIT, reader.LAYER, reader.MOVES, reader.SOURCE) == (
            entry["unit"], entry["layer"], entry["moves"], entry["source"])
        assert entry["moves"] == c.kind.RATE


@pytest.mark.parametrize("cell", CELLS)
def test_config_is_the_programs(cell):
    c = harness.resolve(BENCH, cell)
    cfg = harness.port_config(c.config)
    entry = harness.find(BENCH["configs"],
                         harness.find(BENCH["workloads"], cell,
                                      "workload")["config"], "configuration")
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    assert cfg.tensor_parallel == 1 and cfg.use_flash_attention == 1
    for key in entry["reduced"]:
        assert key in c.config


@pytest.mark.parametrize("what", ["workload", "config", "traffic", "kind",
                                  "metric", "cell"])
def test_unknown_names_fail(what, tmp_path):
    bench = json.loads(json.dumps(BENCH))
    w = bench["workloads"][0]
    if what == "workload":
        name = "no-such-cell"
    else:
        name = w["name"]
        if what == "config":
            w["config"] = "no-such-config"
        elif what == "traffic":
            w["traffic"] = "no-such-mix"
        elif what == "metric":
            bench["per_layer"].append(dict(bench["per_layer"][0],
                                           name="no_such_metric"))
        elif what == "cell":
            w["name"] = name = "no-such-cell-file"
            for m in bench["end_to_end"] + bench["per_layer"]:
                m.setdefault("workloads", [])
    if what == "kind":
        base = tmp_path
        for sub in ("configs", "cells", "traffic"):
            (base / sub).mkdir()
        src = harness.BENCH_DIR
        (base / "configs" / f"{w['config']}.json").write_text(
            (src / "configs" / f"{w['config']}.json").read_text())
        (base / "cells" / f"{name}.json").write_text("{}")
        (base / "traffic" / f"{w['traffic']}.json").write_text(
            json.dumps({"kind": "no_such_kind"}))
    else:
        base = harness.BENCH_DIR
    with pytest.raises(harness.UnknownName):
        harness.resolve(bench, name, base)


def test_program_options_the_program_lacks_are_refused():
    c = json.loads((harness.BENCH_DIR / "configs" /
                    "olmoe-1b-7b-4l.json").read_text())
    with pytest.raises(ValueError):
        harness.port_config(dict(c, qk_norm=True))
    with pytest.raises(ValueError):
        harness.port_config(dict(c, no_such_setting=1))
