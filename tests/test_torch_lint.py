"""The repo's own checkers pass over the port: the docs checker (every
link, flag and code path the README and docs/ name exists; the README's
port section included) and the codec hot-path lint on the port's
``runtime/codec.py``."""
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("args", [
    ["tools/check_docs.py"],
    ["tools/check_codec_hotpath.py", "--file",
     "src/repro_torch/runtime/codec.py"],
], ids=["check_docs", "check_codec_hotpath"])
def test_checker_passes(args):
    proc = subprocess.run([sys.executable, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
