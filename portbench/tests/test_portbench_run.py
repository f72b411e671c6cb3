"""Whole runs of small cells on the CPU, the harness's look for a chip
skipped: the result has the contract's keys, the reference agrees with
the program in float32, and with the timed path broken underneath
``correct`` comes out false."""
import json
import math
import time

import pytest

from portbench import harness

SMALL = harness.BENCH_DIR / "tests" / "small"
SEED = 2 ** 31 + 77


def bench():
    b = harness.load_json(harness.ROOT / "BENCHMARK.json")
    names = {"train": ["tiny.train", "tinymoe.train", "tiny32.train",
                       "tinymoe32.train"],
             "prefill": ["tiny.prefill", "tiny32.prefill"]}
    b["configs"] = [{"name": n} for n in ("tiny", "tinymoe", "tiny32",
                                          "tinymoe32")]
    b["workloads"] = [{"name": n, "config": n.split(".")[0],
                       "traffic": f"{k}_small", "chips": 1}
                      for k, ns in names.items() for n in ns]
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"] = names["train" if "train" in m["name"]
                                   else "prefill"]
    return b


def run(cell, fault=None, trace=False):
    return harness.run(bench(), cell, SEED, 0.3, trace,
                       t_start=time.perf_counter(), base=SMALL,
                       device="cpu", fault=fault, chip_check=False)


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.prefill"])
def test_result_has_the_contracts_keys(cell):
    r = run(cell)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "check"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {
        "train_tokens_per_s" if "train" in cell else "prefill_tokens_per_s",
        "peak_mem_gb", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in r["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        r["device"])
    json.dumps(r)


@pytest.mark.parametrize("cell", ["tiny32.train", "tinymoe32.train",
                                  "tiny32.prefill"])
def test_reference_agrees_with_the_program_in_f32(cell):
    r = run(cell)
    assert r["correct"]
    assert all(c["value"] < 2e-5 for c in r["check"].values())


@pytest.mark.parametrize("cell,fault", [
    ("tiny.train", "unchanged"), ("tiny.train", "half_batch"),
    ("tinymoe.train", "unchanged"), ("tinymoe.train", "half_batch"),
    ("tiny.prefill", "half_batch"), ("tiny.prefill", "alter_answer")])
def test_broken_timed_path_is_not_correct(cell, fault):
    r = run(cell, fault)
    assert r["correct"] is False and r["failed"] >= 1
    assert any(not (c["value"] <= c["limit"]) for c in r["check"].values())


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.prefill"])
def test_unknown_fault_is_refused(cell):
    with pytest.raises(ValueError):
        run(cell, "exchange_left_out")


def test_every_check_number_is_finite():
    r = run("tinymoe.train")
    assert all(math.isfinite(c["value"]) for c in r["check"].values())


@pytest.mark.parametrize("cell,number", [("tiny.train", "grad_gap"),
                                         ("tiny.prefill", "logits_rel_l2")])
def test_control_reads_above_the_program(cell, number):
    c = harness.resolve(bench(), cell, SMALL)
    program = run(cell)["check"][number]["value"]
    control = c.kind.control_readings(c, SEED, "cpu")[number]
    assert control > 3 * program
