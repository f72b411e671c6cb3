"""Nothing the benchmark runs imports JAX or the JAX package, and the
yardstick imports nothing of the program either: each imported module's
top-level name is compared whole (``repro_torch`` begins with
``repro``)."""
import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "ftpipehd"}
PROGRAM = {"repro_torch", "ftpipehd_torch"}
# the yardstick: it may not read the program
YARDSTICK = ["reference.py", "weights.py", "flops.py", "peaks.py",
             "synthetic.py", "trace.py"]


def top_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            names.add(node.module.split(".")[0])
    return names


def sources():
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_names(path) & FORBIDDEN


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_reads_no_program(name):
    assert not top_names(BENCH / name) & (FORBIDDEN | PROGRAM)


def test_whole_names_compared():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.models".split(".")[0] in FORBIDDEN


def test_forbidden_names_match_the_harness():
    from portbench import harness
    assert harness.FORBIDDEN == FORBIDDEN
