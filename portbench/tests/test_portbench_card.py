"""On the card, at each cell's own size: the control (the reference in
lower precision, put in the program's place) fails the cell's limits,
and the program's timed path passes them. Skips without a CUDA device;
run on the card with ``python -m pytest portbench/tests -m card``."""
import pytest

from portbench import calibrate, harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2 ** 31 + 4242


def over(readings, limits):
    return [k for k, lim in limits.items() if not readings[k] <= lim]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(card, cell):
    c = harness.resolve(BENCH, cell)
    assert over(c.kind.control_readings(c, SEED, card), c.limits)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_the_limits(card, cell):
    c = harness.resolve(BENCH, cell)
    readings = calibrate.program_readings(c, SEED, card, seconds=3.0)
    assert not over(readings, c.limits)
